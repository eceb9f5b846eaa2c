"""Noise schedulers: DDPM for training; DDIM, PNDM, k-LMS and
DPM-Solver++(2M) for sampling.

Counterpart of ``ladi_vton_tpu/diffusion/schedulers.py``.  SD-2
configuration: scaled_linear betas 0.00085 -> 0.012 over 1000 steps,
epsilon prediction, steps_offset 1, no clip_sample, set_alpha_to_one
False.

The samplers share the JAX package's loop protocol, which the try-on
pipeline's denoise loop drives:

* ``set_timesteps(n, device)`` returns the plan (an int64 tensor; PNDM's
  is n + 1 long) and puts every per-step coefficient the plan needs on
  ``device`` as a table;
* ``init_loop_state(latents)`` returns the sampler's carried state (the
  epsilon, x0 or derivative history), as tensors on the latents' device;
* ``scale_input(sample, step_index, t)`` scales the UNet input (LMS);
* ``loop_step(state, model_output, step_index, t, sample)`` returns
  ``(state, prev_sample)``.

``step_index`` and ``t`` may be device tensors (the pipeline passes 0-d
int64 views of ``arange`` and of the plan): the coefficients are read
from the tables with ``index_select``, and PNDM's branches on its
counters are ``torch.where`` on device tensors, so a step never reads a
value back to the host.  Host-side precomputation follows the JAX
package: DPM's coefficients in float64, LMS's integrated with
``scipy.integrate.quad``; the device arithmetic is fp32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"  # 'epsilon' | 'v_prediction'
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    clip_sample: bool = False


def _make_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end,
                            cfg.num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")
    return np.cumprod(1.0 - betas).astype(np.float32)


def _at(table: torch.Tensor, index) -> torch.Tensor:
    """``table[index]`` for an int or a 0-d integer tensor, read on the
    table's device with no host synchronisation."""
    index = torch.as_tensor(index, device=table.device).reshape(1)
    return table.index_select(0, index)[0]


def _table(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def _predict_x0(cfg: SchedulerConfig, a, s, x, out):
    """x0 from the model output at x = a x0 + s eps (fp32 tensors)."""
    if cfg.prediction_type == "epsilon":
        return (x - s * out) / a
    if cfg.prediction_type == "v_prediction":
        return a * x - s * out
    raise ValueError(cfg.prediction_type)


class DDPMScheduler:
    """The forward (noising) process, for training."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self.alphas_cumprod = _make_alphas_cumprod(config)

    def _alphas(self, sample, timesteps) -> torch.Tensor:
        table = torch.as_tensor(self.alphas_cumprod, device=sample.device)
        a = table[timesteps.to(sample.device)].to(sample.dtype)
        return a.reshape(a.shape + (1,) * (sample.dim() - a.dim()))

    def add_noise(self, sample, noise, timesteps) -> torch.Tensor:
        """q(x_t | x_0): sqrt(a_t) x0 + sqrt(1 - a_t) eps."""
        a = self._alphas(sample, timesteps)
        return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise

    def get_velocity(self, sample, noise, timesteps) -> torch.Tensor:
        """The v-prediction target: sqrt(a) eps - sqrt(1 - a) x0."""
        a = self._alphas(sample, timesteps)
        return torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * sample


class DDIMScheduler:
    """Deterministic DDIM (eta = 0) with diffusers' timestep spacing.

    ``set_timesteps`` reads each step's ᾱ_t and ᾱ_prev from the fp32
    table and keeps their square roots as an (n, 4) device table; a step
    is the JAX update in fp32."""

    init_noise_sigma = 1.0

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self.alphas_cumprod = _make_alphas_cumprod(config)
        self.final_alpha_cumprod = (np.float32(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])

    def set_timesteps(self, num_inference_steps: int,
                      device=None) -> torch.Tensor:
        """The plan: stride T // n, descending, plus steps_offset."""
        cfg = self.config
        ratio = cfg.num_train_timesteps // num_inference_steps
        ts = ((np.arange(num_inference_steps) * ratio).round()[::-1]
              .astype(np.int64) + cfg.steps_offset)
        prev = ts - ratio
        a_t = self.alphas_cumprod[ts]
        a_prev = np.where(prev >= 0,
                          self.alphas_cumprod[np.maximum(prev, 0)],
                          self.final_alpha_cumprod).astype(np.float32)
        # fp32 square roots, as the JAX step takes them on the device
        self._coeffs = _table(np.stack([
            np.sqrt(a_t), np.sqrt(1 - a_t), np.sqrt(a_prev),
            np.sqrt(np.maximum(1 - a_prev, 0))], axis=1), device)
        self.num_inference_steps = num_inference_steps
        return torch.as_tensor(ts, device=device)

    def init_loop_state(self, latents: torch.Tensor):
        return ()

    def scale_input(self, sample, step_index, t):
        return sample

    def loop_step(self, state, model_output, step_index, t, sample):
        """One x_t -> x_{t - stride} update, in fp32."""
        sa, sb, sa_prev, sb_prev = _at(self._coeffs, step_index).unbind()
        x = sample.float()
        out = model_output.float()
        x0 = _predict_x0(self.config, sa, sb, x, out)
        eps = (out if self.config.prediction_type == "epsilon"
               else sa * out + sb * x)
        if self.config.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        prev = sa_prev * x0 + sb_prev * eps
        return (), prev.to(sample.dtype)


class PNDMScheduler:
    """PLMS (PNDM with skip_prk_steps, the SD configuration).

    The plan repeats its second timestep, so the UNet runs n + 1 times.
    The state is the epsilon history ``ets`` (4 x latents), its fill
    ``ets_count``, the sample ``cur_sample`` the duplicated step restarts
    from and the step ``counter``, all tensors; the branches of the JAX
    step (``jnp.where``, ``jnp.select``) are ``torch.where`` on them."""

    init_noise_sigma = 1.0

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self.alphas_cumprod = _make_alphas_cumprod(config)
        self.final_alpha_cumprod = (np.float32(1.0) if config.set_alpha_to_one
                                    else self.alphas_cumprod[0])

    def set_timesteps(self, num_inference_steps: int,
                      device=None) -> torch.Tensor:
        cfg = self.config
        ratio = cfg.num_train_timesteps // num_inference_steps
        base = ((np.arange(num_inference_steps) * ratio).round()
                .astype(np.int64) + cfg.steps_offset)[::-1]
        plan = np.concatenate([base[:1], base[1:2], base[1:]])
        self.num_inference_steps = num_inference_steps
        self._acp = _table(self.alphas_cumprod, device)
        self._final = _table(self.final_alpha_cumprod, device)
        return torch.as_tensor(plan, device=device)

    def _alpha(self, t: torch.Tensor) -> torch.Tensor:
        return torch.where(t >= 0, _at(self._acp, t.clamp(min=0)),
                           self._final)

    def _prev_sample(self, sample, timestep, prev_timestep, eps):
        a_t = self._alpha(timestep)
        a_prev = self._alpha(prev_timestep)
        b_t = 1.0 - a_t
        b_prev = 1.0 - a_prev
        coef = (a_prev - a_t) / (
            torch.sqrt(a_t) * (torch.sqrt(a_prev * b_t)
                               + torch.sqrt(a_t * b_prev)))
        return (torch.sqrt(a_prev / a_t) * sample.float()
                - coef * eps.float()).to(sample.dtype)

    def init_loop_state(self, latents: torch.Tensor) -> dict:
        dev = latents.device
        return {
            "ets": torch.zeros((4,) + tuple(latents.shape), device=dev),
            "ets_count": torch.zeros((), dtype=torch.int32, device=dev),
            "cur_sample": torch.zeros_like(latents),
            "counter": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def scale_input(self, sample, step_index, t):
        return sample

    def loop_step(self, state, model_output, step_index, t, sample):
        """One PLMS update; returns (state, prev_sample)."""
        stride = self.config.num_train_timesteps // self.num_inference_steps
        t = torch.as_tensor(t, device=sample.device)
        counter = state["counter"]
        is_second = counter == 1
        eps = model_output.float()

        # history update (skipped on the duplicated second call)
        ets = torch.where(is_second, state["ets"],
                          torch.cat([state["ets"][1:], eps[None]]))
        ets_count = torch.where(is_second, state["ets_count"],
                                (state["ets_count"] + 1).clamp(max=4))
        prev_t = torch.where(is_second, t, t - stride)
        t_eff = torch.where(is_second, t + stride, t)

        e1, e2, e3, e4 = ets[3], ets[2], ets[1], ets[0]
        # jnp.select: the first true condition wins, so apply them last
        # to first
        blended = (55 * e1 - 59 * e2 + 37 * e3 - 9 * e4) / 24.0
        blended = torch.where(ets_count == 3,
                              (23 * e1 - 16 * e2 + 5 * e3) / 12.0, blended)
        blended = torch.where(ets_count == 2, (3 * e1 - e2) / 2.0, blended)
        blended = torch.where((ets_count == 1) & is_second, (eps + e1) / 2.0,
                              blended)
        blended = torch.where((ets_count == 1) & (counter == 0), eps,
                              blended)

        cur_sample = torch.where(counter == 0, sample,
                                 state["cur_sample"]).to(sample.dtype)
        base = torch.where(is_second, cur_sample, sample)
        prev = self._prev_sample(base, t_eff, prev_t, blended)
        return {"ets": ets, "ets_count": ets_count, "cur_sample": cur_sample,
                "counter": counter + 1}, prev


class DPMSolverMultistepScheduler:
    """DPM-Solver++(2M), midpoint form (diffusers' defaults:
    algorithm_type "dpmsolver++", solver_order 2, timestep_spacing
    "linspace", final_sigmas_type "zero", lower_order_final).

    ``set_timesteps`` works out every update coefficient on the host in
    float64 (first order at step 0, which has no history, and at the
    final zero-sigma step); a step is three multiply-adds over the
    latents, and the state is the previous step's x0."""

    init_noise_sigma = 1.0

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        acp = _make_alphas_cumprod(config).astype(np.float64)
        # karras-convention sigmas over the train timesteps
        self._sigmas_all = np.sqrt((1.0 - acp) / acp)

    def set_timesteps(self, num_inference_steps: int,
                      device=None) -> torch.Tensor:
        T = self.config.num_train_timesteps
        ts = (np.linspace(0, T - 1, num_inference_steps + 1)
              .round()[::-1][:-1].astype(np.int64))
        s = np.interp(ts.astype(np.float64),
                      np.arange(len(self._sigmas_all)), self._sigmas_all)
        s = np.concatenate([s, [0.0]])  # final_sigmas_type "zero"
        # VP-space alpha and sigma, and lambda = -log(s) (+inf at the end)
        with np.errstate(divide="ignore"):
            lam = -np.log(s)
        alpha = 1.0 / np.sqrt(1.0 + s * s)
        sigma = s * alpha

        n = num_inference_steps
        c_skip, c_d0, c_d1 = np.zeros(n), np.zeros(n), np.zeros(n)
        h = lam[1:] - lam[:-1]
        for i in range(n):
            final = s[i + 1] == 0.0
            # the limits as h -> inf: exp(-h) -> 0, sigma ratio -> 0
            exp_neg_h = 0.0 if final else np.exp(-h[i])
            c_skip[i] = 0.0 if final else sigma[i + 1] / sigma[i]
            c_d0[i] = -alpha[i + 1] * (exp_neg_h - 1.0)
            if not (i == 0 or final):
                c_d1[i] = 0.5 * c_d0[i] / (h[i - 1] / h[i])
        self.num_inference_steps = n
        self.c_skip, self.c_d0, self.c_d1 = c_skip, c_d0, c_d1
        self.alpha, self.sigma = alpha, sigma
        # one row per step: alpha, sigma, c_skip, c_d0, c_d1
        self._coeffs = _table(np.stack(
            [alpha[:n], sigma[:n], c_skip, c_d0, c_d1], axis=1), device)
        return torch.as_tensor(ts, device=device)

    def init_loop_state(self, latents: torch.Tensor) -> torch.Tensor:
        return torch.zeros(latents.shape, device=latents.device)

    def scale_input(self, sample, step_index, t):
        return sample

    def loop_step(self, state, model_output, step_index, t, sample):
        """(x0 history, eps, i, x_i) -> (new history, x_{i+1})."""
        a_t, s_t, c_skip, c_d0, c_d1 = _at(self._coeffs,
                                           step_index).unbind()
        x = sample.float()
        x0 = _predict_x0(self.config, a_t, s_t, x, model_output.float())
        if self.config.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        d1 = x0 - state  # c_d1 is zero where the order is 1
        prev = c_skip * x + c_d0 * x0 + c_d1 * d1
        return x0, prev.to(sample.dtype)


class LMSDiscreteScheduler:
    """Linear multistep (k-LMS) sampler in sigma space, of order 4.

    ``set_timesteps`` integrates the LMS coefficient of every (step,
    history) pair on the host; a step is a linear combination of the
    derivative history, which is the state.  ``init_noise_sigma`` (the
    N(0, 1) -> x_T scale) is read after ``set_timesteps``."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig(),
                 order: int = 4):
        self.config = config
        self.order = order
        acp = _make_alphas_cumprod(config).astype(np.float64)
        self._sigmas_all = np.sqrt((1 - acp) / acp)
        self.init_noise_sigma = float(np.sqrt(self._sigmas_all[-1] ** 2 + 1))

    def set_timesteps(self, num_inference_steps: int,
                      device=None) -> torch.Tensor:
        T = self.config.num_train_timesteps
        ts = np.linspace(0, T - 1, num_inference_steps,
                         dtype=np.float64)[::-1].copy()
        low = np.floor(ts).astype(int)
        high = np.ceil(ts).astype(int)
        frac = ts - low
        sigmas = ((1 - frac) * self._sigmas_all[low]
                  + frac * self._sigmas_all[high])
        self.sigmas = np.concatenate([sigmas, [0.0]])
        self.num_inference_steps = num_inference_steps
        self.init_noise_sigma = float(np.sqrt(sigmas[0] ** 2 + 1))
        coeffs = np.zeros((num_inference_steps, self.order))
        for step in range(num_inference_steps):
            order = min(step + 1, self.order)
            for j in range(order):
                coeffs[step, j] = self._lms_coeff(step, j, order)
        self.coeffs = coeffs
        self._coeffs = _table(coeffs, device)
        self._sigmas = _table(self.sigmas, device)
        return torch.as_tensor(np.round(ts).astype(np.int64), device=device)

    def _lms_coeff(self, t: int, j: int, order: int) -> float:
        import scipy.integrate

        sig = self.sigmas

        def fn(tau):
            prod = 1.0
            for k in range(order):
                if k != j:
                    prod *= (tau - sig[t - k]) / (sig[t - j] - sig[t - k])
            return prod

        return scipy.integrate.quad(fn, sig[t], sig[t + 1], epsrel=1e-4)[0]

    def init_loop_state(self, latents: torch.Tensor) -> torch.Tensor:
        return torch.zeros((self.order,) + tuple(latents.shape),
                           device=latents.device)

    def scale_input(self, sample, step_index, t):
        sigma = _at(self._sigmas, step_index)
        return sample / torch.sqrt(sigma * sigma + 1)

    def loop_step(self, state, model_output, step_index, t, sample):
        """(derivative history, eps at the scaled input, i, x_sigma) ->
        (new history, prev sample)."""
        sigma = _at(self._sigmas, step_index)
        x = sample.float()
        x0 = x - sigma * model_output.float()
        derivs = torch.cat([((x - x0) / sigma)[None], state[:-1]])
        update = torch.tensordot(_at(self._coeffs, step_index), derivs,
                                 dims=1)
        return derivs, (x + update).to(sample.dtype)


SCHEDULERS = {
    "ddim": DDIMScheduler,
    "pndm": PNDMScheduler,
    "lms": LMSDiscreteScheduler,
    "dpm": DPMSolverMultistepScheduler,
}


def make_scheduler(name: str, config: SchedulerConfig = SchedulerConfig()):
    """A sampler by its CLI name: ``ddim``, ``pndm``, ``lms`` or ``dpm``."""
    if name not in SCHEDULERS:
        raise ValueError(
            f"unknown scheduler {name!r}; choose from {sorted(SCHEDULERS)}")
    return SCHEDULERS[name](config)
