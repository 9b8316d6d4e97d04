"""Samplers of the port (``naturaldiffusion_tpu/samplers/``): the direct
recursions, predictor-corrector and probability-flow ODE sampling, RK45,
DPM-Solver and DEIS.  The controllable samplers wait (ROADMAP.md, Queue
A, slice 4)."""

from . import deis
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
           "DPMSolver", "model_wrapper", "deis"]
