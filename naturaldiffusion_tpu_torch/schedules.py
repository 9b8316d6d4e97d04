"""Noise-schedule math (host-side, float64 numpy).

Copy of ``naturaldiffusion_tpu/schedules.py`` (numpy only), kept here so the
port never imports the JAX package.

Covers the schedule families the reference derives coefficient matrices from:

* discrete DDPM/DDIM (linear betas, 1000 steps, with respacing) —
  reference: ``src/AnalyzeDDPMDDIM.py:76-123,250-294``
* continuous linear VP-SDE (score-SDE convention, beta in [0.1, 20]) —
  reference: ``src/AnalyzeEulerHeun.py:15-43``,
  ``deps/score_sde_pytorch/sde_lib.py:112-164``
* half-logSNR (lambda) machinery incl. ``inverse_lambda`` —
  reference: ``src/AnalyzeDPMSolver.py:61-225`` / ``deps/dpm_solver_pytorch.py``
* rectified-flow sigma grid — reference: ``src/AnalyzeFlowMatching.py:20-23``
* DEIS rho reparameterisation + time grids — reference: ``deps/th_deis/sde.py``

All of this is derivation-time math: it produces the per-node scalars that the
derivers in :mod:`naturaldiffusion_tpu_torch.coeffs` propagate through the affine
tracker.  The on-device engine only ever sees the resulting coefficient
matrices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ---------------------------------------------------------------------------
# Timestep respacing
# ---------------------------------------------------------------------------


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """Evenly-respaced subset of ``range(num_timesteps)``.

    Same respacing semantics as the improved-diffusion scheme the reference
    uses (``src/AnalyzeDDPMDDIM.py:23-73``): split the original process into
    sections and stride each with fractional steps; ``"ddimN"`` selects the
    fixed DDIM striding.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            want = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == want:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"no integer stride gives exactly {want} steps")
        section_counts = [int(x) for x in section_counts.split(",")]

    per, extra = divmod(num_timesteps, len(section_counts))
    taken: list[int] = []
    start = 0
    for i, count in enumerate(section_counts):
        size = per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot take {count} steps from a section of {size}")
        stride = (size - 1) / (count - 1) if count > 1 else 1.0
        pos = 0.0
        for _ in range(count):
            taken.append(start + round(pos))
            pos += stride
        start += size
    return set(taken)


# ---------------------------------------------------------------------------
# Discrete DDPM / DDIM schedules
# ---------------------------------------------------------------------------


def linear_betas(n: int = 1000, lo: float = 1e-4, hi: float = 0.02) -> np.ndarray:
    return np.linspace(lo, hi, n, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class DiscreteVP:
    """A discrete VP diffusion over an (optionally respaced) timestep grid.

    ``timesteps[i]`` is the original-process index of grid node ``i``
    (ascending).  ``alphas_bar`` are the marginal signal**2 coefficients at
    those nodes.  Derived per-node quantities are the DDPM posterior and the
    DDIM update coefficients (reference: ``src/AnalyzeDDPMDDIM.py:76-123``
    and ``:250-294``).
    """

    timesteps: np.ndarray          # [n] int, ascending
    alphas_bar: np.ndarray         # [n] cumulative alpha-bar at each node

    @classmethod
    def create(cls, num_step: int | None = None, n_train: int = 1000,
               betas: np.ndarray | None = None) -> "DiscreteVP":
        if betas is None:
            betas = linear_betas(n_train)
        alphas_bar = np.cumprod(1.0 - betas)
        if num_step is None:
            idx = np.arange(len(betas))
        else:
            idx = np.array(sorted(space_timesteps(len(betas), str(int(num_step)))))
        return cls(timesteps=idx, alphas_bar=alphas_bar[idx])

    # per-node step quantities over the (respaced) grid -------------------

    @property
    def alphas(self) -> np.ndarray:
        """Per-step alpha between consecutive grid nodes."""
        prev = np.append(1.0, self.alphas_bar[:-1])
        return self.alphas_bar / prev

    @property
    def betas(self) -> np.ndarray:
        return 1.0 - self.alphas

    @property
    def alphas_bar_prev(self) -> np.ndarray:
        return np.append(1.0, self.alphas_bar[:-1])

    # DDPM ancestral (posterior) coefficients ------------------------------

    @property
    def posterior_var(self) -> np.ndarray:
        return self.betas * (1.0 - self.alphas_bar_prev) / (1.0 - self.alphas_bar)

    @property
    def posterior_log_var(self) -> np.ndarray:
        # First entry clamped as in the reference (src/AnalyzeDDPMDDIM.py:83)
        return np.log(np.append(1e-5, self.posterior_var[1:]))

    @property
    def posterior_std(self) -> np.ndarray:
        return np.sqrt(np.exp(self.posterior_log_var))

    @property
    def ddpm_coeff_x0(self) -> np.ndarray:
        """Posterior-mean weight on predicted x0."""
        return np.sqrt(self.alphas_bar_prev) * self.betas / (1.0 - self.alphas_bar)

    @property
    def ddpm_coeff_xt(self) -> np.ndarray:
        """Posterior-mean weight on x_t."""
        return np.sqrt(self.alphas) * (1.0 - self.alphas_bar_prev) / (1.0 - self.alphas_bar)

    # DDIM (eta=0) update coefficients -------------------------------------

    @property
    def ddim_coeff_xt(self) -> np.ndarray:
        return np.sqrt((1.0 - self.alphas_bar_prev) / (1.0 - self.alphas_bar))

    @property
    def ddim_coeff_x0(self) -> np.ndarray:
        return np.sqrt(self.alphas_bar_prev) - self.ddim_coeff_xt * np.sqrt(self.alphas_bar)

    # x_t -> x0 conversion (given predicted eps) ---------------------------

    @property
    def coeff_xt2x0(self) -> np.ndarray:
        return np.sqrt(1.0 / self.alphas_bar)

    @property
    def coeff_eps2x0(self) -> np.ndarray:
        return np.sqrt(1.0 / self.alphas_bar - 1.0)


# ---------------------------------------------------------------------------
# Continuous linear VP-SDE (score-SDE convention)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinearVPSDE:
    """dx = -1/2 beta(t) x dt + sqrt(beta(t)) dw with linear beta(t).

    Reference: ``src/AnalyzeEulerHeun.py:15-43`` and
    ``deps/score_sde_pytorch/sde_lib.py:112-164``.
    """

    beta_0: float = 0.1
    beta_1: float = 20.0
    T: float = 1.0

    def beta(self, t):
        return self.beta_0 + t * (self.beta_1 - self.beta_0)

    def sde_coeff(self, t):
        """Drift factor f(t) (so drift = f(t)*x) and diffusion g(t)."""
        b = self.beta(t)
        return -0.5 * b, np.sqrt(b)

    def log_alpha(self, t):
        return -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def marginal_coeff(self, t):
        """(alpha_t, sigma_t): x_t ~ N(alpha_t x_0, sigma_t^2 I)."""
        la = self.log_alpha(t)
        return np.exp(la), np.sqrt(1.0 - np.exp(2.0 * la))

    def alpha(self, t):
        return np.exp(self.log_alpha(t))

    def sigma(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.log_alpha(t)))

    # half-logSNR machinery (DPM-Solver) -----------------------------------

    def lam(self, t):
        """lambda_t = log(alpha_t) - log(sigma_t)."""
        la = self.log_alpha(t)
        return la - 0.5 * np.log(1.0 - np.exp(2.0 * la))

    def inverse_lam(self, lam):
        """t such that lambda_t = lam (closed form for the linear schedule).

        Matches ``deps/dpm_solver_pytorch.py`` / ``src/AnalyzeDPMSolver.py:217-220``.
        """
        tmp = 2.0 * (self.beta_1 - self.beta_0) * np.logaddexp(-2.0 * lam, 0.0)
        delta = self.beta_0 ** 2 + tmp
        return tmp / (np.sqrt(delta) + self.beta_0) / (self.beta_1 - self.beta_0)

    # DEIS rho reparameterisation ------------------------------------------

    def t2alpha(self, t):
        return np.exp(2.0 * self.log_alpha(t))

    def alpha2t(self, alpha_bar):
        """Inverse of t2alpha for the linear schedule (quadratic root)."""
        log_mean = np.log(alpha_bar) / 2.0
        a = 0.25 * (self.beta_1 - self.beta_0)
        b = 0.5 * self.beta_0
        return (-b + np.sqrt(b ** 2 - 4.0 * a * log_mean)) / (2.0 * a)

    def t2rho(self, t):
        """sigma/alpha-style reparam used by DEIS (``deps/th_deis/vpsde.py:66-69``)."""
        ab = self.t2alpha(t)
        return np.sqrt((1.0 - ab) / ab)

    def rho2t(self, rho):
        return self.alpha2t(1.0 / (rho ** 2 + 1.0))

    def d_log_alpha_bar_dt(self, t):
        """d/dt log(alpha_bar(t)) = 2 d/dt log(alpha(t)) = -beta(t)."""
        return -self.beta(t)


@dataclasses.dataclass(frozen=True)
class PiecewiseVPSDE:
    """Discrete-alpha VP process fitted piecewise-linearly over integer
    timesteps — the ``deps/th_deis/vpsde.py:105-124`` ``DiscreteVPSDE``:
    time runs over [0, N-1] and ``alpha_bar(t)`` interpolates the trained
    table (clipped to [1e-7, 1-1e-7]).  Duck-types ``LinearVPSDE``'s
    DEIS-facing surface (t2alpha/alpha2t/t2rho/rho2t/d_log_alpha_bar_dt,
    sampling_eps/T as the grid ends)."""

    alphas_bar: tuple        # trained cumulative-alpha table, len N

    @classmethod
    def from_betas(cls, betas) -> "PiecewiseVPSDE":
        return cls(tuple(np.cumprod(1.0 - np.asarray(betas, np.float64))))

    @property
    def _t(self):
        return np.arange(len(self.alphas_bar), dtype=np.float64)

    @property
    def _ab(self):
        return np.clip(np.asarray(self.alphas_bar), 1e-7, 1.0 - 1e-7)

    # DEIS surface ----------------------------------------------------------
    @property
    def T(self) -> float:               # sampling_T
        return float(len(self.alphas_bar) - 1)

    @property
    def sampling_eps(self) -> float:
        return 0.0

    def t2alpha(self, t):
        return np.clip(np.interp(t, self._t, self._ab), 1e-7, 1.0 - 1e-7)

    def alpha2t(self, alpha_bar):
        # alpha decreasing in t: interp over (2 - alpha) ascending, as the
        # reference does
        return np.clip(np.interp(2.0 - np.asarray(alpha_bar),
                                 2.0 - self._ab, self._t),
                       self._t[0], self._t[-1])

    def t2rho(self, t):
        ab = self.t2alpha(t)
        return np.sqrt((1.0 - ab) / ab)

    def rho2t(self, rho):
        return self.alpha2t(1.0 / (np.asarray(rho) ** 2 + 1.0))

    def d_log_alpha_bar_dt(self, t):
        """Piecewise-linear table derivative of log(alpha_bar)."""
        log_ab = np.log(self._ab)
        grads = np.gradient(log_ab, self._t)
        return np.interp(t, self._t, grads)

    def marginal_coeff(self, t):
        ab = self.t2alpha(t)
        return np.sqrt(ab), np.sqrt(1.0 - ab)

    def log_alpha(self, t):
        return 0.5 * np.log(self.t2alpha(t))


# ---------------------------------------------------------------------------
# Rectified flow
# ---------------------------------------------------------------------------


def flow_sigmas(num_step: int) -> np.ndarray:
    """Uniform sigma grid in [0, 1]; x_t = (1-sigma) x0 + sigma eps.

    Reference: ``src/AnalyzeFlowMatching.py:21``.
    """
    return np.linspace(0.0, 1.0, num_step + 1)


# ---------------------------------------------------------------------------
# DEIS time grids
# ---------------------------------------------------------------------------


def deis_rev_ts(sde: LinearVPSDE, num_step: int, ts_order: float,
                ts_phase: str = "t", t0: float = 1e-3,
                t1: float | None = None) -> np.ndarray:
    """Descending sampling-time grid for DEIS (``deps/th_deis/sde.py:54-92``).

    ``t`` phase: power-law grid in t; ``log``: geometric in rho;
    ``rho``: EDM-style power grid in rho.
    """
    t1 = sde.T if t1 is None else t1
    if ts_phase == "t":
        return np.power(
            np.linspace(t1 ** (1.0 / ts_order), t0 ** (1.0 / ts_order), num_step + 1),
            ts_order)
    if ts_phase == "log":
        rho0, rho1 = sde.t2rho(t0), sde.t2rho(t1)
        rev_rhos = np.exp(np.linspace(np.log(rho1), np.log(rho0), num_step + 1))
        return sde.rho2t(rev_rhos)
    if ts_phase == "rho":
        rho0, rho1 = sde.t2rho(t0), sde.t2rho(t1)
        rev_rhos = np.power(
            rho1 ** (1.0 / ts_order)
            + np.linspace(0.0, 1.0, num_step + 1)
            * (rho0 ** (1.0 / ts_order) - rho1 ** (1.0 / ts_order)),
            ts_order)
        return sde.rho2t(rev_rhos)
    raise ValueError(f"unknown ts_phase {ts_phase!r} (want t|log|rho)")
