"""Natural-Inference engine: coefficient matrices run as one loop."""
from .ni import (NISchedule, natural_inference, natural_inference_checked,
                 natural_inference_reference)
from .predictions import PREDICTION_TYPES, from_x0, to_x0

__all__ = ["NISchedule", "natural_inference", "natural_inference_checked",
           "natural_inference_reference", "PREDICTION_TYPES", "from_x0",
           "to_x0"]
