"""Samplers of the port (``naturaldiffusion_tpu/samplers/``): the direct
recursions, predictor-corrector and probability-flow ODE sampling, RK45,
DPM-Solver, DEIS, and PC inpainting and colorization."""

from . import deis
from .controllable import couple, decouple, get_pc_colorizer, get_pc_inpainter
from .direct import (ddim, ddpm_ancestral, flow_euler, ode_euler, ode_heun,
                     sde_euler)
from .dpm_solver import DPMSolver, NoiseScheduleVP, model_wrapper
from .pc import (get_corrector, get_ode_sampler, get_pc_sampler,
                 get_predictor, register_corrector, register_predictor)
from .rk45 import rk45_integrate

__all__ = ["ddpm_ancestral", "ddim", "ode_euler", "sde_euler", "ode_heun",
           "flow_euler", "get_pc_sampler", "get_ode_sampler",
           "get_predictor", "get_corrector", "register_predictor",
           "register_corrector", "rk45_integrate", "NoiseScheduleVP",
           "DPMSolver", "model_wrapper", "deis", "get_pc_inpainter",
           "get_pc_colorizer", "decouple", "couple"]
