"""Graph-diffusion engine: corruption, the training loss with
importance-sampled timesteps, and the reverse sampler, for the three
variants of the JAX package.

Port of the JAX package's ``diffusion/engine.py``. The 2-state discrete
channel is a per-cell Bernoulli on the closed-form probability of state 1;
the reverse sampler is a Python loop over the T steps with the
degree-guided synthetic-graph growth. The importance sampler's loss history
(``LtState``) lives on the device and is updated there: no step reads a
value back to the host.

Random draws: every stochastic function takes either an explicit
``torch.Generator`` or pre-drawn uniforms/normals/timesteps, so tests can
inject the JAX package's own draws (``bernoulli(p)`` is ``uniform < p`` in
both).

Fidelity quirks kept (``fidelity=True``): alpha_bar of the discrete channel
is ``ts / batch_size`` (clipped to [0, 1]); discrete noise only deletes;
timesteps are drawn twice per training step (the second draw drives the
model, the weight and the Lt update).

Variants (``Diffusion.variant``):

* ``discrete`` (the reference's ``GaussianDiffusionDiscrete``, the live
  class): the discrete one-hot corruption and the degree-guided growth of a
  synthetic graph in the reverse loop.
* ``legacy`` (``GaussianDiffusion``): the one-hot channel is a continuous
  ``q_sample`` of the one-hot at its own, independent timestep draw; no
  contrastive loss; the reverse loop iterates the posterior with no graph.
* ``ablation`` (``GaussianDiffusionAblation``): the corruption of the
  discrete class, but the model sees the clean ``x_start`` and the clean
  one-hot, only the graph is corrupted, and the reverse loop always applies
  the degree gate.

``noise_scale`` 0 builds no coefficient tables: the reverse path then
iterates the model on its own output with no graph, for every variant.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from gdmcf_torch.diffusion.schedules import (DiffusionCoeffs, compute_coeffs,
                                             extract, get_betas)


class MeanType(enum.Enum):
    START_X = enum.auto()
    EPSILON = enum.auto()


class PSampleDraws(NamedTuple):
    """Pre-drawn randomness for ``p_sample``, in the sampler's order.

    ``init_u`` ([B, n] uniform) and ``init_c`` ([B, n] normal) start the
    chain when ``sampling_steps > 0``; then, for each reverse step from
    t = T-1 down to 0: ``sprinkle[s]`` ([B, n] uniform), ``gate[s]`` ([B]
    uniform) and, with ``sampling_noise``, ``noise[s]`` ([B, n] normal).
    """

    init_u: Optional[torch.Tensor] = None
    init_c: Optional[torch.Tensor] = None
    sprinkle: Sequence[torch.Tensor] = ()
    gate: Sequence[torch.Tensor] = ()
    noise: Sequence[torch.Tensor] = ()
    # legacy: the one-hot channel starts as a q_sample of the one-hot, from
    # these normals [B, n, 2] in place of ``init_u``; its reverse loop draws
    # only ``noise``
    init_noise_u: Optional[torch.Tensor] = None


class TimestepDraws(NamedTuple):
    """Pre-drawn timesteps [B] of both ``sample_timesteps`` branches."""

    uniform: torch.Tensor
    importance: torch.Tensor


class TrainDraws(NamedTuple):
    """Pre-drawn randomness for ``training_losses``, in its order: the
    one-hot channel's timesteps and corruption uniforms [B, n], the model's
    timesteps and normals [B, n], then the model's dropout uniforms. The
    legacy variant corrupts the one-hot channel with ``noise_u`` ([B, n, 2]
    normals) at the ``ts_u`` draw instead of ``corrupt_u``."""

    ts_u: Optional[TimestepDraws] = None
    corrupt_u: Optional[torch.Tensor] = None
    ts: Optional[TimestepDraws] = None
    noise: Optional[torch.Tensor] = None
    dropout: Sequence[torch.Tensor] = ()
    noise_u: Optional[torch.Tensor] = None


class LegacyNoiseDraws(NamedTuple):
    """Pre-drawn randomness for ``legacy_apply_noise``, in the JAX
    package's key order: the keep uniforms [B, n], the uniform item indices
    [B, n] (integers in [0, N)), the threshold (an integer in
    [int(0.8 N), N]) and the blend uniforms [B, n]."""

    pick: torch.Tensor
    uniform_j: torch.Tensor
    thresh: torch.Tensor
    mix: torch.Tensor


class LtState(NamedTuple):
    """Importance-sampling state: a per-timestep ring of recent losses."""

    history: torch.Tensor  # [steps, history_num_per_term] float32
    count: torch.Tensor    # [steps] int32

    @staticmethod
    def create(steps: int, history_num_per_term: int = 10,
               device=None) -> "LtState":
        return LtState(
            history=torch.zeros((steps, history_num_per_term),
                                dtype=torch.float32, device=device),
            count=torch.zeros((steps,), dtype=torch.int32, device=device))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


def mix_tensors(t1: torch.Tensor, t2: torch.Tensor, mix_prob: float = 0.5,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bernoulli blend: each cell comes from ``t1`` with probability
    ``mix_prob``, else from ``t2`` (``u``: pre-drawn uniforms)."""
    assert t1.shape == t2.shape
    mask = (_uniform(t1.shape, t1, generator, u) < mix_prob).to(t1.dtype)
    return mask * t1 + (1.0 - mask) * t2


def absorbing_qt_bar(alpha_bar_t: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """Absorbing-state transition matrices Q_bar = a I + (1 - a) 1 (the
    reference's unnormalized helper, kept for API parity): [B] -> [B, C,
    C]."""
    a = alpha_bar_t.reshape(-1, 1, 1)
    eye = torch.eye(num_classes, dtype=a.dtype, device=a.device)[None]
    return a * eye + (1.0 - a) * torch.ones(
        (1, num_classes, num_classes), dtype=a.dtype, device=a.device)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL divergence between two diagonal Gaussians, elementwise (defined
    but unused on the reference's live path, kept for API parity)."""
    mean1, logvar1, mean2, logvar2 = (
        torch.as_tensor(v, dtype=torch.float32)
        for v in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


# model(x, t, x_U, index=..., graph=..., rcloss=..., generator=...,
#       dropout_u=...) -> (scores, closs or None)
ModelApply = Callable[..., tuple]


def _uniform(shape, like: torch.Tensor, generator, given):
    if given is not None:
        return given.to(like.device, torch.float32)
    return torch.rand(shape, generator=generator, device=like.device)


def _normal(shape, like: torch.Tensor, generator, given):
    if given is not None:
        return given.to(like.device, torch.float32)
    return torch.randn(shape, generator=generator, device=like.device)


@dataclass(frozen=True)
class Diffusion:
    mean_type: MeanType
    steps: int
    noise_scale: float
    discrete_eps: float          # epsilon of u_x (reference ``--discrete``)
    coeffs: Optional[DiffusionCoeffs] = None
    cat_one_hot: bool = True     # OneHotMatrix == 2
    index_in: bool = True        # the model reads index (reference indexIn)
    user_guided: bool = True
    fidelity: bool = True
    history_num_per_term: int = 10
    uniform_prob: float = 0.001
    variant: str = "discrete"    # discrete | legacy | ablation

    @staticmethod
    def create(cfg, variant: str = "discrete", device=None,
               index_in: bool = True) -> "Diffusion":
        """``index_in``: the model's ``needs_index``; only such a model is
        asked for the contrastive loss, as in the reference."""
        if variant not in ("discrete", "legacy", "ablation"):
            raise ValueError(f"unknown diffusion variant {variant!r}")
        mean_type = (MeanType.START_X if cfg.mean_type == "x0"
                     else MeanType.EPSILON)
        coeffs = None
        if cfg.noise_scale != 0.0:
            betas = get_betas(cfg.noise_schedule, cfg.steps, cfg.noise_scale,
                              cfg.noise_min, cfg.noise_max, cfg.beta_fixed)
            coeffs = compute_coeffs(betas, device=device)
        return Diffusion(
            mean_type=mean_type, steps=cfg.steps,
            noise_scale=cfg.noise_scale, discrete_eps=cfg.discrete,
            coeffs=coeffs, cat_one_hot=(cfg.OneHotMatrix == 2),
            index_in=index_in, user_guided=bool(cfg.user_guided),
            fidelity=cfg.fidelity,
            history_num_per_term=cfg.history_num_per_term, variant=variant)

    # -- continuous channel ------------------------------------------------
    def q_sample(self, x_start, t, noise):
        c = self.coeffs
        return (extract(c.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
                + extract(c.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
                * noise)

    def q_posterior_mean(self, x_start, x_t, t):
        c = self.coeffs
        return (extract(c.posterior_mean_coef1, t, x_t.ndim) * x_start
                + extract(c.posterior_mean_coef2, t, x_t.ndim) * x_t)

    def predict_xstart_from_eps(self, x_t, t, eps):
        c = self.coeffs
        return (extract(c.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
                - extract(c.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps)

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        """alpha_bar / (1 - alpha_bar); t = -1 wraps to the last step."""
        ac = self.coeffs.alphas_cumprod[t]
        return ac / (1.0 - ac)

    # -- discrete channel --------------------------------------------------
    def _alpha_bar_discrete(self, ts: torch.Tensor,
                            batch_size: int) -> torch.Tensor:
        if self.fidelity:
            # reference quirk: alpha_bar := ts / batch_size, clipped so a
            # partial batch with B < steps stays a probability
            return (ts.float() / batch_size).clamp(0.0, 1.0)
        return self.coeffs.alphas_cumprod[ts].float()

    def discrete_p_one(self, alpha_bar: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
        """P(state 1 | x) under Q_bar = a*I + (1-a)*u_x."""
        a = alpha_bar.reshape(alpha_bar.shape
                              + (1,) * (x.ndim - alpha_bar.ndim))
        p1 = (1.0 - a) * (1.0 - self.discrete_eps)
        return torch.where(x > 0.5, a + p1, p1)

    def apply_noise(self, ts, x_binary, generator=None, u=None):
        """Binary state-1 sample of the 2-state channel, [B, n]."""
        a = self._alpha_bar_discrete(ts, x_binary.shape[0])
        p1 = self.discrete_p_one(a, x_binary)
        u = _uniform(p1.shape, x_binary, generator, u)
        return (u < p1).to(x_binary.dtype)

    def corrupt_discrete(self, ts, x_binary, generator=None, u=None):
        """One-hot [B, n, 2] of ``apply_noise(x0) AND onehot(x0)``:
        delete-only noise with a (0, 0) state for disagreeing cells."""
        s = self.apply_noise(ts, x_binary, generator, u)
        c1 = x_binary * s
        c0 = (1.0 - x_binary) * (1.0 - s)
        return torch.stack([c0, c1], dim=-1)

    # -- the legacy class's n-state corruption -----------------------------
    def legacy_apply_noise(self, ts: torch.Tensor, x: torch.Tensor,
                           num_nodes: Optional[int] = None,
                           x_base: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[LegacyNoiseDraws] = None):
        """The legacy class's n-state corruption in closed form, as the JAX
        package implements the reference's intent (its own code cannot
        run: a [B, 2, 2] alpha is broadcast against an N x N identity).
        Under Q_bar = a I_N + (1 - a) 1, an occupied cell (b, i) keeps its
        own index i with probability a / (a + N (1 - a)), else takes a
        uniform index in [0, N); an empty cell takes a uniform index (the
        a -> 0 limit, where the reference's multinomial would raise). The
        index is binarized by the reference's threshold quirk, index >
        randint(0.8 N, N], and blended with ``x`` at p 0.8 (or with
        ``x_base`` at p 0.99) by ``mix_tensors``. On nothing's training
        path; O(B N), where the reference would build [B, N, N]."""
        n = x.shape[1] if num_nodes is None else num_nodes
        dev = x.device
        a = self._alpha_bar_discrete(ts, x.shape[0])[:, None]   # ts/B quirk
        if draws is None:
            pick = torch.rand(x.shape, generator=generator, device=dev)
            uniform_j = torch.randint(0, n, x.shape, generator=generator,
                                      device=dev)
            thresh = torch.randint(int(n * 0.8), n + 1, (),
                                   generator=generator, device=dev)
            mix = torch.rand(x.shape, generator=generator, device=dev)
        else:
            pick, mix = (draws.pick.to(dev, torch.float32),
                         draws.mix.to(dev, torch.float32))
            uniform_j = draws.uniform_j.to(dev).long()
            thresh = draws.thresh.to(dev).long()
        keep = pick < a / (a + n * (1.0 - a))
        own_j = torch.arange(x.shape[1], device=dev)[None, :].expand(x.shape)
        sampled = torch.where(keep & (x > 0.5), own_j, uniform_j)
        x_t = (sampled > thresh).to(x.dtype)
        if x_base is None:
            return mix_tensors(x, x_t, 0.8, u=mix)
        return mix_tensors(x_base, x_t, 0.99, u=mix)

    def _continuous_onehot(self, ts, x_start, generator, noise_u):
        """The legacy one-hot channel: a q_sample of the clean one-hot
        [B, n, 2] at ``ts`` (the clean one-hot at noise_scale 0)."""
        x_su = torch.stack([1.0 - x_start, x_start], dim=-1)
        noise_u = _normal(x_su.shape, x_start, generator, noise_u)
        if self.noise_scale == 0.0:
            return x_su
        return self.q_sample(x_su, ts, noise_u)

    # -- timestep importance sampling --------------------------------------
    def sample_timesteps(self, lt: LtState, batch_size: int,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[TimestepDraws] = None):
        """(t [B] int64, pt [B] float32). Uniform draws (pt = 1) until every
        Lt row is full; then draws by importance, sqrt(E[loss^2]) with a
        ``uniform_prob`` floor, and pt = pt_all[t] * steps. Both branches
        are drawn and the choice is made on the device, so no step waits
        for the host. Own draws: ``randint`` for the uniform branch, the
        inverse CDF of one uniform for the importance branch."""
        dev = lt.history.device
        all_full = (lt.count == self.history_num_per_term).all()
        lt_sqrt = torch.sqrt((lt.history ** 2).mean(dim=-1))
        pt_all = lt_sqrt / lt_sqrt.sum()
        pt_all = (pt_all * (1.0 - self.uniform_prob)
                  + self.uniform_prob / self.steps)
        if draws is None:
            t_uni = torch.randint(0, self.steps, (batch_size,),
                                  generator=generator, device=dev)
            u = torch.rand((batch_size,), generator=generator, device=dev)
            cdf = torch.cumsum(pt_all, dim=0)
            t_imp = torch.searchsorted(cdf, u * cdf[-1], right=True)
        else:
            t_uni, t_imp = (draws.uniform.to(dev).long(),
                            draws.importance.to(dev).long())
        # before the rows fill, pt_all may be NaN; that branch is not taken
        t_imp = t_imp.clamp(0, self.steps - 1)
        t = torch.where(all_full, t_imp, t_uni)
        pt = torch.where(all_full, pt_all[t] * self.steps,
                         torch.ones((batch_size,), device=dev))
        return t, pt

    def update_lt(self, lt: LtState, ts: torch.Tensor,
                  losses: torch.Tensor) -> LtState:
        """The ring update in closed form, for all timesteps at once: each
        row's first ``count`` entries, then that timestep's batch losses in
        batch order; keep the last H and saturate the count. Equal to the
        reference's per-example loop (``update_lt_sequential``)."""
        h = self.history_num_per_term
        b = ts.shape[0]
        dev = lt.history.device
        losses = losses.detach().to(lt.history.dtype)
        mask = ts[None, :] == torch.arange(self.steps, device=dev)[:, None]
        c = lt.count.long()
        seq = torch.zeros((self.steps, h + b), dtype=lt.history.dtype,
                          device=dev)
        seq[:, :h] = torch.where(torch.arange(h, device=dev)[None, :]
                                 < c[:, None], lt.history, 0.0)
        # this step's losses go to c, c+1, ...; the others add 0 to a
        # parked last cell
        pos = c[:, None] + torch.cumsum(mask, dim=1) - 1
        pos = torch.where(mask, pos, h + b - 1)
        seq.scatter_add_(1, pos, torch.where(mask, losses[None, :], 0.0))
        total = c + mask.sum(dim=1)
        start = (total - h).clamp_min(0)
        rows = torch.gather(seq, 1, start[:, None]
                            + torch.arange(h, device=dev)[None, :])
        return LtState(history=rows,
                       count=total.clamp_max(h).to(torch.int32))

    def update_lt_sequential(self, lt: LtState, ts: torch.Tensor,
                             losses: torch.Tensor) -> LtState:
        """The reference's loop, one example at a time (append while
        filling, shift left once full); the oracle of ``update_lt``."""
        h = self.history_num_per_term
        hist, cnt = lt.history.clone(), lt.count.clone()
        losses = losses.detach().to(hist.dtype)
        for i in range(ts.shape[0]):
            t, loss = int(ts[i]), losses[i]
            if int(cnt[t]) >= h:
                hist[t] = torch.cat([hist[t, 1:], loss[None]])
            else:
                hist[t, int(cnt[t])] = loss
                cnt[t] += 1
        return LtState(history=hist, count=cnt)

    # -- training loss -----------------------------------------------------
    def training_losses(self, model: ModelApply, x_start: torch.Tensor,
                        index: torch.Tensor, lt: LtState,
                        reweight: bool = True,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[TrainDraws] = None):
        """(per-example loss [B], new LtState, aux dict). Own draws: the
        one-hot channel's timesteps and corruption, the model's timesteps,
        the noise, then the model's dropout (legacy: the one-hot channel's
        after the noise).

        legacy: the one-hot channel is a continuous q_sample of the one-hot
        at its own timestep draw, independent of the model's (the
        reference's legacy class draws twice against the same Lt state),
        and no contrastive loss is asked for. ablation: the model sees the
        clean rows and the clean one-hot; only the graph is the corrupted
        one-hot."""
        if self.coeffs is None and reweight:
            raise ValueError(
                "noise_scale=0 builds no diffusion coefficient tables; "
                "training requires reweight=False in that mode")
        draws = draws or TrainDraws()
        B = x_start.shape[0]
        legacy = self.variant == "legacy"
        x_tU = None
        if self.cat_one_hot and not legacy:
            ts_u, _ = self.sample_timesteps(lt, B, generator, draws.ts_u)
            x_tU = self.corrupt_discrete(ts_u, x_start, generator,
                                         draws.corrupt_u)
        ts, pt = self.sample_timesteps(lt, B, generator, draws.ts)
        noise = _normal(x_start.shape, x_start, generator, draws.noise)
        x_t = (self.q_sample(x_start, ts, noise) if self.noise_scale != 0.0
               else x_start)
        if self.cat_one_hot and legacy:
            ts_u, _ = self.sample_timesteps(lt, B, generator, draws.ts_u)
            x_tU = self._continuous_onehot(ts_u, x_start, generator,
                                           draws.noise_u)
        # the contrastive loss is requested on the indexIn path only
        rcloss = self.index_in and self.cat_one_hot and not legacy
        if self.variant == "ablation":
            x_in = x_start
            xu_in = torch.stack([1.0 - x_start, x_start], dim=-1)
        else:
            x_in, xu_in = x_t, x_tU
        model_output, closs = model(x_in, ts, xu_in, index=index, graph=x_tU,
                                    rcloss=rcloss, generator=generator,
                                    dropout_u=draws.dropout)
        target = x_start if self.mean_type == MeanType.START_X else noise
        assert model_output.shape == target.shape == x_start.shape
        mse = mean_flat((target - model_output) ** 2)
        if not reweight:
            weight, loss = torch.ones_like(mse), mse
        elif self.mean_type == MeanType.START_X:
            weight = torch.where(ts == 0, 1.0, self.snr(ts - 1) - self.snr(ts))
            loss = mse
        else:
            c = self.coeffs
            ac, ac_prev = c.alphas_cumprod[ts], c.alphas_cumprod_prev[ts]
            weight = (1.0 - ac) / ((1.0 - ac_prev) ** 2
                                   * (1.0 - c.betas[ts]))
            weight = torch.where(ts == 0, 1.0, weight)
            likelihood = mean_flat((x_start - self.predict_xstart_from_eps(
                x_t, ts, model_output)) ** 2 / 2.0)
            loss = torch.where(ts == 0, likelihood, mse)
        weighted = weight * loss
        new_lt = self.update_lt(lt, ts, weighted)
        final = weighted / pt
        if closs is not None:
            final = final + closs * 0.1
        aux = {"mse": mse, "ts": ts, "pt": pt,
               "closs": closs if closs is not None else mse.new_zeros(())}
        return final, new_lt, aux

    # -- reverse sampler ---------------------------------------------------
    def p_sample(self, model: ModelApply, x_start: torch.Tensor,
                 index: torch.Tensor, sampling_steps: int,
                 sampling_noise: bool = False,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[PSampleDraws] = None) -> torch.Tensor:
        """The reverse loop; returns scores [B, n]. discrete: with the
        synthetic-graph growth; ablation: the same growth with the degree
        gate always on, and the clean rows and one-hot into the model and
        the posterior; legacy: the posterior iterated with no graph;
        noise_scale 0 (any variant): the model iterated on its own output
        with no graph."""
        assert sampling_steps <= self.steps, "Too much steps in inference."
        if sampling_steps > 0 and self.coeffs is None:
            raise ValueError("noise_scale=0 supports only sampling_steps=0")
        draws = draws or PSampleDraws()
        B, n = x_start.shape
        dev = x_start.device
        legacy = self.variant == "legacy"
        ablation = self.variant == "ablation"

        x_tU = None
        if self.cat_one_hot:
            if sampling_steps == 0:
                x_tU = torch.stack([1.0 - x_start, x_start], dim=-1)
            else:
                t0 = torch.full((B,), sampling_steps - 1, dtype=torch.long,
                                device=dev)
                x_tU = (self._continuous_onehot(t0, x_start, generator,
                                                draws.init_noise_u)
                        if legacy else
                        self.corrupt_discrete(t0, x_start, generator,
                                              draws.init_u))
        if sampling_steps == 0:
            x_t = x_start
        else:
            t0 = torch.full((B,), sampling_steps - 1, dtype=torch.long,
                            device=dev)
            x_t = self.q_sample(x_start, t0, _normal(
                x_start.shape, x_start, generator, draws.init_c))

        def step_t(i):
            return torch.full((B,), i, dtype=torch.long, device=dev)

        if self.noise_scale == 0.0:
            # no coefficient tables: iterate the model on its own output
            for i in range(self.steps - 1, -1, -1):
                x_t, _ = model(x_t, step_t(i), x_tU, index=index, graph=None)
            return x_t

        def posterior(x_in, t, model_output, s):
            if self.mean_type == MeanType.START_X:
                pred_xstart = model_output
            else:
                pred_xstart = self.predict_xstart_from_eps(x_in, t,
                                                           model_output)
            mean = self.q_posterior_mean(pred_xstart, x_in, t)
            if not sampling_noise:
                return mean
            nz = (t != 0).to(mean.dtype).reshape(-1, *([1] * (mean.ndim - 1)))
            noise = _normal(mean.shape, mean, generator,
                            draws.noise[s] if draws.noise else None)
            log_var = extract(self.coeffs.posterior_log_variance_clipped,
                              t, mean.ndim)
            return mean + nz * torch.exp(0.5 * log_var) * noise

        if legacy:
            for s, i in enumerate(range(self.steps - 1, -1, -1)):
                t = step_t(i)
                model_output, _ = model(x_t, t, x_tU, index=index,
                                        graph=None)
                x_t = posterior(x_t, t, model_output, s)
            return x_t

        # ALWAYS-ON REPAIR: an all-zero batch would divide by zero in the
        # reference; the floor disables the degree gate for it instead
        deg = x_start.sum(dim=1)
        deg_p = deg / deg.max().clamp_min(1e-12)
        if ablation:
            # the model and the posterior see the clean rows and one-hot;
            # only the grown graph varies from step to step
            x_tU = torch.stack([1.0 - x_start, x_start], dim=-1)
        g = torch.zeros_like(x_start)
        for s, i in enumerate(range(self.steps - 1, -1, -1)):
            t = step_t(i)
            p1 = self.discrete_p_one(self._alpha_bar_discrete(t, B), g)
            u = _uniform((B, n), x_start, generator,
                         draws.sprinkle[s] if draws.sprinkle else None)
            grown = u < p1
            # the ablation class applies the degree gate always; the live
            # class honors user_guided
            if self.user_guided or ablation:
                ug = _uniform((B,), x_start, generator,
                              draws.gate[s] if draws.gate else None)
                grown = grown & (ug < deg_p)[:, None]
            g = torch.logical_or(g > 0.5, grown).to(x_start.dtype)
            graph = torch.stack([1.0 - g, g], dim=-1)
            x_in = x_start if ablation else x_t
            model_output, _ = model(x_in, t, x_tU, index=index, graph=graph)
            x_t = posterior(x_in, t, model_output, s)
        return x_t
