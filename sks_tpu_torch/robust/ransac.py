"""Fixed-shape vectorized RANSAC for homography fitting.

Port of ``sks_tpu/robust/ransac.py``: a fixed batch of B hypotheses is drawn,
solved with the batched minimal solver, scored against every correspondence,
and the top-K candidates are refined and selected — no data-dependent loop,
and no host synchronisation anywhere on the path (every accept/reject is a
``torch.where``, every pick an on-device index).  Degenerate hypotheses
(collinear samples, duplicate indices, non-finite H) score -1 instead of being
branched on.

The one exception is :func:`ransac_homography_adaptive`, the confidence
early-exit loop: how many chunks it evaluates depends on the data, and eager
PyTorch has no device-side loop, so it reads one boolean back from the device
before each chunk (:func:`_read_flag`, and nothing else).

On CUDA tensors the fused path (:func:`ransac_homography_fused`) solves and
scores all B hypotheses in the hand-written kernel
``sks_tpu_torch.kernels.aca_cuda.aca_solve_score_soa``; on CPU tensors the
same call runs that kernel's plain version.  The general path solves its
batch on CUDA in the kernel whose body is the registered solver's own core:
a float32 batch in K1 for 'aca', K3 for 'sks', K4-GE for 'rho_ge'; a float64
batch of those three in their instances of K5, the float64 solve.  'gpt_lu',
'ho' and 'ndlt' stay on their eager ``SOLVERS_H`` forms, which are other
formulations than their kernels' cores (as in the JAX package).
``df64_scoring=True`` scores in float64 (``ops.fp64.residual2_fp64``).

Randomness: draws come from an explicit ``torch.Generator``.  Its stream is
not ``jax.random``'s, so every entry point also takes ``indices=``, a (B, 4)
integer tensor used in place of the draw — the seam through which the tests
hold this port against the JAX package on identical minimal sets.
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch
from torch import Tensor

from sks_tpu_torch.geom.homography import apply_homography, inv_h
from sks_tpu_torch.kernels import (
    FP64_SOLVE_KERNELS,
    SOLVE_KERNELS,
    from_soa_h,
    to_soa,
)
from sks_tpu_torch.kernels.aca_cuda import aca_solve_score_soa
from sks_tpu_torch.kernels.irls_cuda import irls_refine
from sks_tpu_torch.ops import SOLVERS_H, aca_valid_mask, sks_valid_mask
from sks_tpu_torch.ops.fp64 import residual2_fp64
from sks_tpu_torch.ops.ndlt import ndlt_h
from sks_tpu_torch.utils import graphs
from sks_tpu_torch.utils.profiling import annotate, count

__all__ = [
    "ADAPTIVE_MAX_CHUNK",
    "FUSED_ADAPTIVE_MIN_CHUNK",
    "RansacConfig",
    "RansacResult",
    "fused_kernel_threshold",
    "magsac_weights",
    "ransac_homography",
    "ransac_homography_adaptive",
    "ransac_homography_fused",
    "ransac_homography_fused_batch",
    "sample_minimal_sets",
    "sample_minimal_sets_prosac",
    "prosac_prefix_sizes",
    "score_hypotheses",
]

#: MAGSAC++ residual-space dimensionality: the symmetric transfer error is a
#: 4-vector (forward + backward 2D reprojection), so nu = 4 and the 0.99
#: chi^2_4 quantile gives tau(sigma) = k * sigma with k = sqrt(13.2767).
_MAGSAC_NU = 4.0
_MAGSAC_K = 3.6437

def _scalar(value, like: Tensor) -> Tensor:
    """0-d tensor on ``like``'s device and dtype, made without a host sync."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _take(x: Tensor, i: Tensor) -> Tensor:
    """``x[i]`` for a 0-d or 1-element index tensor, without a host sync."""
    return x.index_select(0, i.reshape(1))[0]


def _all_finite(h: Tensor) -> Tensor:
    """(..., 3, 3) -> (...,) True where every entry is finite."""
    return torch.isfinite(h).flatten(-2).all(-1)


def magsac_weights(r2: Tensor, sigma_max, k: float = _MAGSAC_K) -> Tensor:
    """Sigma-marginalized point weights (MAGSAC-style sigma-consensus).

    Marginalizing the truncated-quadratic gain over ``sigma ~ U(0, sigma_max]``
    with inlier radius ``k * sigma`` has the closed form

        (1/s) ∫_0^s max(0, 1 - r²/(k²σ²)) dσ = (1 - r / (k s))²_+ ,  s = σ_max

    (see ``sks_tpu.robust.ransac.magsac_weights`` for the derivation).

    Args:
      r2: (...) squared residuals (symmetric transfer, 4-dim).
      sigma_max: maximum noise scale in pixels (float or 0-d tensor).

    Returns:
      weights in [0, 1], same shape as ``r2``.
    """
    if isinstance(sigma_max, Tensor):
        sigma_max = sigma_max.to(r2.dtype)
    else:
        sigma_max = _scalar(sigma_max, r2)
    r = torch.sqrt(torch.clamp(r2, min=0.0))
    w = torch.clamp(1.0 - r / (k * sigma_max), 0.0, 1.0) ** 2
    return torch.where(torch.isfinite(r2), w, torch.zeros_like(w))


@dataclass(frozen=True)
class RansacConfig:
    """Static RANSAC parameters: the fields and defaults of the JAX package's.

    ``df64_scoring`` keeps the JAX package's name; here it scores in native
    float64.
    """

    num_hypotheses: int = 2048
    threshold: float = 3.0  # pixels, symmetric transfer
    solver: str = "aca"
    refine_iters: int = 2  # IRLS refinement rounds on the winning consensus
    scoring: str = "inliers"  # 'inliers' (RANSAC) | 'msac' | 'magsac' | 'lmeds'
    sampling: str = "uniform"  # 'uniform' | 'prosac' (points sorted by quality)
    # MAGSAC++ maximum noise scale.  None -> 3 * threshold.
    sigma_max: float | None = None
    # LO-RANSAC candidate count: the top-K hypotheses are polished and the
    # winner is selected post-polish.
    lo_candidates: int = 4
    # Score residuals in float64 (ops.fp64.residual2_fp64): the JAX package's
    # double-float scoring, in native fp64.
    df64_scoring: bool = False
    # Final geometric polish: annealed-threshold Levenberg-Marquardt on the
    # selected model's consensus (robust.polish.anneal_polish).
    final_polish: bool = True
    # Evaluate the hypothesis batch with the fused solve+score kernel.
    # Composes with the adaptive early-exit loop, PROSAC sampling and
    # point_mask.  Requires solver='aca', scoring in
    # {'inliers','msac','magsac'}, num_hypotheses % 128 == 0.
    fused: bool = False
    # Store minimal-set coordinates in bfloat16 on the fused path (halves the
    # kernel's input bytes; the kernel computes in float32).
    bf16_hypotheses: bool = False


@dataclass
class RansacResult:
    h: Tensor  # (3, 3) best model, H[2,2]-normalized
    inlier_mask: Tensor  # (N,) bool
    num_inliers: Tensor  # () int32
    score: Tensor  # () float — scoring-dependent quality (higher better)


def sample_minimal_sets(generator: torch.Generator, num_points: int,
                        batch: int) -> Tensor:
    """(B, 4) random index tuples into the correspondence set.

    Independent uniform draws on the generator's device (collisions allowed —
    they produce degenerate hypotheses that scoring masks out).
    """
    return torch.randint(0, int(num_points), (batch, 4), generator=generator,
                         device=generator.device)


#: Solvers whose batched solve kernels have the registered solver's own core
#: as their body (so kernel and eager op agree bit for bit on the card, K5's
#: up to its h22 division).  The kernels of 'gpt_lu', 'ho' and 'ndlt' run
#: other formulations than
#: ``SOLVERS_H`` ('unrolled' GPT, closed3 HO, the N-point NDLT).
_KERNEL_SOLVERS = ("aca", "sks", "rho_ge")


def _solve_batch(name: str, s4: Tensor, t4: Tensor) -> Tensor:
    """(B, 4, 2) minimal sets -> (B, 3, 3) hypotheses (any scale).

    A float32 or float64 batch on CUDA goes through the solver's kernel
    where it is the same core (``_KERNEL_SOLVERS``): float32 in its
    ``SOLVE_KERNELS`` kernel (up to scale), float64 in its K5 instance
    (``FP64_SOLVE_KERNELS``, h22 = 1; scoring ignores the scale).
    Everything else goes through ``SOLVERS_H``.
    """
    if name in _KERNEL_SOLVERS and s4.device.type == "cuda":
        kernels = {torch.float32: SOLVE_KERNELS,
                   torch.float64: FP64_SOLVE_KERNELS}.get(s4.dtype)
        if kernels is not None:
            kernel = kernels[name].kernel
            return from_soa_h(kernel(to_soa(s4), to_soa(t4)))
    return SOLVERS_H[name](s4, t4)


def prosac_prefix_sizes(num_points: int, batch: int, m: int = 4):
    """PROSAC growth schedule: prefix size n_t for each hypothesis t.

    The Chum & Matas (2005) growth function — how many top-quality
    correspondences hypothesis t may draw from — computed with the standard
    recurrence T'_{n+1} = T'_n + ceil(T_{n+1} - T_n),
    T_{n+1} = T_n (n+1)/(n+1-m).  Data-independent (depends only on
    ``num_points`` and ``batch``) and computed on the host; a caller puts it
    on the device once.

    Returns an int32 numpy array (batch,) with m <= n_t <= num_points,
    non-decreasing.
    """
    n_pts = int(num_points)
    t_n = float(batch)
    for i in range(m):
        t_n *= (m - i) / (n_pts - i)  # T_m
    sizes = np.empty(batch, np.int32)
    n = m
    t_prime = 1.0
    for t in range(batch):
        if t + 1 > t_prime and n < n_pts:
            t_next = t_n * (n + 1) / (n + 1 - m)
            t_prime += math.ceil(t_next - t_n)
            t_n = t_next
            n += 1
        sizes[t] = n
    return sizes


def sample_minimal_sets_prosac(
    generator: torch.Generator | None,
    num_points: int,
    batch: int,
    sizes: Tensor | None = None,
    *,
    u: Tensor | None = None,
) -> Tensor:
    """(B, 4) progressive index tuples (PROSAC; Chum & Matas 2005).

    Assumes correspondences are sorted by descending match quality.
    Hypothesis t draws point n_t - 1 (the newest admitted) plus 3 *distinct*
    picks from the first n_t - 1 (sequential shifted draws — at the smallest
    prefix a with-replacement draw would waste ~78% of hypotheses on
    duplicates).

    ``sizes`` optionally supplies a precomputed growth schedule slice so
    chunked callers can continue one global schedule instead of restarting it
    (see :func:`ransac_homography_adaptive`).  ``u`` optionally supplies the
    (B, 3) uniforms in [0, 1) in place of the generator's draw: given those of
    ``jax.random.uniform(key, (B, 3))`` the indices are the JAX package's,
    index for index.

    Padded fixed-shape sets: pad at the *end* (the natural layout for a
    quality-sorted matcher).  The growth schedule then touches padded slots
    only in its late uniform tail, where scoring's ``point_mask`` discards
    them.
    """
    if u is None:
        u = torch.rand((batch, 3), generator=generator,
                       device=generator.device)
    if sizes is None:
        sizes = prosac_prefix_sizes(num_points, batch)
    sizes = torch.as_tensor(sizes, device=u.device).long()  # (B,)
    m = (sizes - 1).to(u.dtype)  # companion pool: the top n_t - 1 points
    i0 = torch.floor(u[:, 0] * m).long()
    i1 = torch.floor(u[:, 1] * (m - 1.0)).long()
    i1 = i1 + (i1 >= i0).long()
    i2 = torch.floor(u[:, 2] * (m - 2.0)).long()
    lo = torch.minimum(i0, i1)
    hi = torch.maximum(i0, i1)
    i2 = i2 + (i2 >= lo).long()
    i2 = i2 + (i2 >= hi).long()
    return torch.stack([i0, i1, i2, sizes - 1], dim=-1)


def _sample_chunk(generator, n, config, prosac_sizes=None, point_mask=None):
    if config.sampling == "prosac":
        return sample_minimal_sets_prosac(
            generator, n, config.num_hypotheses, sizes=prosac_sizes
        )
    if config.sampling != "uniform":
        raise ValueError(f"unknown sampling {config.sampling!r}")
    if point_mask is None:
        return sample_minimal_sets(generator, n, config.num_hypotheses)
    # Padded sets: draw only valid indices, by the Gumbel-max trick over the
    # mask (categorical with equal weight on every valid slot), as the JAX
    # package's jax.random.categorical does.  Materializes (B, 4, N) noise.
    u = torch.rand((config.num_hypotheses, 4, n), generator=generator,
                   device=generator.device)
    gumbel = -torch.log(-torch.log(u))
    mask = point_mask.to(generator.device)
    return torch.argmax(
        torch.where(mask, gumbel, torch.full_like(gumbel, -torch.inf)), dim=-1
    )


def _minimal_sets(generator, src, config, point_mask, indices,
                  prosac_sizes=None):
    """The (B, 4) index tuples of one batch: ``indices`` if given, else drawn."""
    b = config.num_hypotheses
    if indices is None:
        if generator is None:
            generator = torch.Generator(device=src.device).manual_seed(0)
        idx = _sample_chunk(generator, src.shape[-2], config, prosac_sizes,
                            point_mask)
    else:
        idx = torch.as_tensor(indices)
        if idx.shape != (b, 4) or idx.is_floating_point():
            raise ValueError(
                f"indices must be an integer ({b}, 4) tensor; got "
                f"{idx.dtype} {tuple(idx.shape)}"
            )
    count("ransac.hypotheses", b)
    return idx.to(device=src.device, dtype=torch.long)


def _residual2(h: Tensor, src: Tensor, tar: Tensor,
               df64: bool = False) -> Tensor:
    """Squared symmetric transfer error of hypotheses (B,3,3) on points (N,2).

    Returns (B, N).  ``df64=True`` computes it in float64
    (:func:`sks_tpu_torch.ops.fp64.residual2_fp64`), returned in the points'
    dtype.
    """
    if df64:
        return residual2_fp64(h, src, tar)
    d1 = apply_homography(h, src) - tar[..., None, :, :]
    hinv = inv_h(h)
    d2 = apply_homography(hinv, tar) - src[..., None, :, :]
    return torch.sum(d1 * d1, dim=-1) + torch.sum(d2 * d2, dim=-1)


def score_hypotheses(
    h: Tensor,
    src: Tensor,
    tar: Tensor,
    threshold: float,
    point_mask: Tensor | None = None,
    scoring: str = "inliers",
    sigma_max: float | None = None,
    df64: bool = False,
):
    """Score a batch of hypotheses against all correspondences.

    Args:
      h: (B, 3, 3) hypotheses (any scale).
      src, tar: (N, 2) correspondences.
      threshold: inlier threshold in pixels (symmetric transfer).
      point_mask: optional (N,) validity for padded point sets.
      scoring: 'inliers' counts; 'msac' sums truncated quadratic gains;
        'magsac' sums :func:`magsac_weights` (sigma_max default
        3 * threshold); 'lmeds' negated median squared residual, inliers by
        the 2.5-robust-sigma rule on the median.

    Returns:
      (scores (B,), inlier_mask (B, N)) — degenerate/non-finite hypotheses get
      score -1 (-inf for lmeds) and empty masks.
    """
    r2 = _residual2(h, src, tar, df64=df64)  # (B, N)
    t2 = _scalar(threshold * threshold, r2)
    finite = _all_finite(h)
    r2 = torch.where(torch.isfinite(r2), r2, torch.full_like(r2, torch.inf))
    inl = r2 < t2
    if point_mask is not None:
        inl = inl & point_mask
    zero = torch.zeros_like(r2)
    if scoring == "inliers":
        score = torch.sum(inl, dim=-1).to(r2.dtype)
    elif scoring == "msac":
        gain = torch.clamp(1.0 - r2 / t2, min=0.0)
        if point_mask is not None:
            gain = torch.where(point_mask, gain, zero)
        score = torch.sum(gain, dim=-1)
    elif scoring == "magsac":
        # The inlier *mask* stays at the user threshold (cv2 semantics); only
        # the score marginalizes sigma.
        g = magsac_weights(
            r2, sigma_max if sigma_max is not None else 3.0 * threshold
        )
        if point_mask is not None:
            g = torch.where(point_mask, g, zero)
        score = torch.sum(g, dim=-1)
    elif scoring == "lmeds":
        nan = torch.full_like(r2, torch.nan)
        r2m = torch.where(point_mask, r2, nan) if point_mask is not None else r2
        # nanquantile at 0.5 interpolates the two middle values, as
        # jnp.nanmedian does (torch.nanmedian would return the lower one).
        med = torch.nanquantile(
            torch.where(torch.isfinite(r2m), r2m, nan), 0.5, dim=-1
        )
        med = torch.where(torch.isfinite(med), med,
                          torch.full_like(med, torch.inf))
        score = -med
        if point_mask is not None:
            nf = torch.sum(point_mask).to(r2.dtype)
            spread = 1.0 + 5.0 / torch.clamp(nf - 4.0, min=1.0)
        else:
            spread = 1.0 + 5.0 / max(r2.shape[-1] - 4.0, 1.0)
        sigma = 2.5 * 1.4826 * spread * torch.sqrt(med)
        # Floor sigma (as cv2 does): on exact data the median residual is ~0.
        sigma = torch.clamp(sigma, min=1e-3)
        inl = r2 < (sigma * sigma)[..., None]
        if point_mask is not None:
            inl = inl & point_mask
    else:
        raise ValueError(f"unknown scoring {scoring!r}")
    worst = -torch.inf if scoring == "lmeds" else -1.0
    score = torch.where(finite, score, torch.full_like(score, worst))
    inl = inl & finite[..., None]
    return score, inl


def _irls_refine(h0: Tensor, src: Tensor, tar: Tensor, iters: int,
                 threshold: float, point_mask: Tensor | None = None,
                 scoring: str = "inliers",
                 sigma_max: float | None = None,
                 df64: bool = False) -> Tensor:
    """Local optimization: annealed IRLS NDLT (LO-RANSAC + GNC).

    ``h0`` is (..., 3, 3): a batch of candidates refits at once (the JAX
    package vmaps over them).  Each iteration rebuilds the weights from the
    current model's residuals at a scale annealed 4x -> 1x; ``scoring='magsac'``
    uses :func:`magsac_weights` instead of a hard threshold.  Padded points
    never receive weight; a refit from fewer than 4 points of weight mass, or
    a non-finite one, keeps the previous model.

    Float32 inputs without float64 scoring that may leave eager PyTorch
    (``utils.graphs.may_leave_eager``: on the card, no gradient to record,
    no torch.func transform) run in one launch of the kernel
    ``kernels.irls_cuda.irls_refine`` (counted by ``ransac.irls_kernel``);
    everything else runs :func:`_irls_refine_eager`, the kernel's plain
    version.
    """
    sm = sigma_max if sigma_max is not None else 3.0 * threshold
    if (not df64 and graphs.may_leave_eager(src, tar, h0)
            and h0.dtype == src.dtype == tar.dtype == torch.float32):
        count("ransac.irls_kernel")
        magsac = scoring == "magsac"
        return irls_refine(h0, src, tar, iters, threshold, point_mask,
                           magsac_k=_MAGSAC_K if magsac else None,
                           sigma_max=sm if magsac else None)
    return _irls_refine_eager(h0, src, tar, iters, threshold, point_mask,
                              scoring, sm, df64)


def _irls_refine_eager(h0, src, tar, iters, threshold, point_mask, scoring,
                       sm, df64):
    """:func:`_irls_refine` in eager operations (``sm``: sigma_max)."""
    pm = None if point_mask is None else point_mask.to(src.dtype)
    h = h0
    for t in range(iters):
        # GNC schedule: 2^(iters-2-t) capped to [1, 4] => e.g. [4,2,1,1].
        scale = min(max(2.0 ** (iters - 2 - t), 1.0), 4.0)
        r2 = _residual2(h, src, tar, df64=df64)
        if scoring == "magsac":
            w = magsac_weights(r2, _scalar(sm, src) * scale).to(src.dtype)
        else:
            thr = _scalar(threshold, src) * scale
            w = (r2 < thr * thr).to(src.dtype)
        if pm is not None:
            w = w * pm
        h_new = ndlt_h(src, tar, weights=w)
        ok = _all_finite(h_new) & (torch.sum(w, dim=-1) >= 4)
        h = torch.where(ok[..., None, None], h_new, h)
    return h


def _top_k(scores: Tensor, k: int) -> Tensor:
    """Indices of the k largest scores, the lower index first among ties.

    ``jax.lax.top_k`` orders ties so; ``torch.topk`` promises no order.
    """
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def _fused_draw(generator, src, tar, config, point_mask, indices=None,
                prosac_sizes=None, lanes: int = 128):
    """Check a fused-path config and draw one pair's batch: the minimal sets
    ``(s4, t4)`` and the fused kernel's ``(src, tar, pts, weights)``.

    ``lanes``: the multiple ``num_hypotheses`` must be (the JAX package's
    rule for its fused path; the kernel takes any B, and the sharded fit,
    whose rank's share of the budget need not be one, passes 1).
    """
    if config.solver != "aca":
        raise ValueError("the fused path is ACA-only")
    if config.scoring not in ("inliers", "msac", "magsac"):
        raise ValueError(f"the fused path cannot score {config.scoring!r}")
    b = config.num_hypotheses
    if b % lanes:
        raise ValueError(f"num_hypotheses must be a multiple of {lanes} on "
                         f"the fused path, as in the JAX package; got {b}")
    idx = _minimal_sets(generator, src, config, point_mask, indices,
                        prosac_sizes)
    s4 = src[idx]  # (B, 4, 2)
    t4 = tar[idx]
    store = torch.bfloat16 if config.bf16_hypotheses else torch.float32
    pts = torch.cat([src.T, tar.T], dim=0).float().contiguous()  # (4, N)
    pw = (torch.ones(src.shape[0], dtype=torch.float32, device=src.device)
          if point_mask is None else point_mask.float().contiguous())
    return (s4, t4), (to_soa(s4).to(store), to_soa(t4).to(store), pts, pw)


def _fused_top(counts, s4, t4, src, tar, config, point_mask):
    """The top-K of one pair's fused scores ``counts`` (B,), re-solved and
    re-scored on the eager path, so downstream selection and polish see
    exactly the general path's numbers.  Returns as :func:`_eval_chunk`."""
    b = config.num_hypotheses
    with annotate("ransac/rescore"):
        top_idx = _top_k(counts, max(1, min(config.lo_candidates, b)))

        # Only the K winning minimal sets are re-solved on the eager path.
        s4k, t4k = s4[top_idx], t4[top_idx]
        h_top = SOLVERS_H["aca"](s4k, t4k)
        h_top = torch.where(aca_valid_mask(s4k, t4k)[..., None, None], h_top,
                            torch.full_like(h_top, torch.nan))
        sc_top, inl = score_hypotheses(
            h_top, src, tar, config.threshold, point_mask, config.scoring,
            config.sigma_max, config.df64_scoring,
        )
        # The kernel ordered candidates by its own scores; the eager re-score
        # can disagree near ties, and _refine_and_pack wants best first.  A
        # stable ascending sort of the negation, as jnp.argsort(-sc_top).
        order = torch.sort(-sc_top, stable=True).indices
        return h_top[order], sc_top[order], _take(inl, order[0])


def _eval_chunk_fused(generator, src, tar, config, point_mask, indices=None,
                      prosac_sizes=None):
    """Fused-kernel twin of :func:`_eval_chunk` (same contract).

    All B hypotheses are solved and scored in one kernel launch; only the
    top-K winning minimal sets are re-solved and re-scored on the eager path.
    Composes with PROSAC indices, padded point sets and bfloat16 storage.
    """
    with annotate("ransac/draw"):
        (s4, t4), (s_soa, t_soa, pts, pw) = _fused_draw(
            generator, src, tar, config, point_mask, indices, prosac_sizes)
    with annotate("ransac/k2"):
        counts = aca_solve_score_soa(
            s_soa, t_soa, pts, fused_kernel_threshold(config),
            point_weights=pw, scoring=config.scoring,
        )
    return _fused_top(counts, s4, t4, src, tar, config, point_mask)


def _eval_chunk(generator, src, tar, config, point_mask, indices=None,
                prosac_sizes=None):
    """Sample + solve + score one fixed-shape batch; return its top-K."""
    count("ransac.chunks")
    with annotate("ransac/chunk"):
        if config.fused:
            return _eval_chunk_fused(generator, src, tar, config, point_mask,
                                     indices, prosac_sizes)
        return _eval_chunk_eager(generator, src, tar, config, point_mask,
                                 indices, prosac_sizes)


def _eval_chunk_eager(generator, src, tar, config, point_mask, indices,
                      prosac_sizes):
    """:func:`_eval_chunk` on the general path: every hypothesis solved and
    scored by eager operations (the solve in its kernel where there is one)."""
    idx = _minimal_sets(generator, src, config, point_mask, indices,
                        prosac_sizes)
    s4 = src[idx]  # (B, 4, 2)
    t4 = tar[idx]
    h = _solve_batch(config.solver, s4, t4)  # (B, 3, 3), up to scale
    valid_mask = {"aca": aca_valid_mask, "sks": sks_valid_mask}.get(
        config.solver)
    if valid_mask is not None:
        # ACA and SKS have their own degeneracy sets: near-degenerate but
        # finite hypotheses score -1 instead of garbage, as in the JAX package.
        valid = valid_mask(s4, t4)
        h = torch.where(valid[..., None, None], h, torch.full_like(h, torch.nan))
    scores, inl = score_hypotheses(
        h, src, tar, config.threshold, point_mask, config.scoring,
        config.sigma_max, config.df64_scoring,
    )
    top_idx = _top_k(scores, max(1, min(config.lo_candidates,
                                        config.num_hypotheses)))
    return h[top_idx], scores[top_idx], _take(inl, top_idx[0])


def _refine_and_pack(h_top, sc_top, inl_best, src, tar, config, point_mask):
    """Shared tail: polish the top-K candidates, select post-polish, normalize.

    Args:
      h_top: (K, 3, 3) best hypotheses by pre-polish score, best first.
      sc_top: (K,) their scores.
      inl_best: (N,) inlier mask of the pre-polish champion.
    """
    h_best, score0 = h_top[0], sc_top[0]
    if config.refine_iters > 0:
        with annotate("ransac/irls"):
            h_pol = _irls_refine(
                h_top, src, tar, config.refine_iters, config.threshold,
                point_mask, config.scoring, config.sigma_max,
                config.df64_scoring,
            )
        # Candidates: every polished model, plus the raw champion as the
        # keep-if-better fallback (last, so polished wins score ties).
        cand = torch.cat([h_pol, h_best[None]], dim=0)
        sc, inls = score_hypotheses(
            cand, src, tar, config.threshold, point_mask,
            config.scoring, config.sigma_max, config.df64_scoring,
        )
        if config.scoring == "lmeds":
            # LMedS selects by median but keeps the refit that explains the
            # most robust-sigma inliers (as cv2 does).
            sel = torch.sum(inls, dim=-1).to(sc.dtype)
        else:
            sel = sc
        idx = torch.argmax(sel)  # the first maximum, as jnp.argmax
        h_best = _take(cand, idx)
        inl_best = _take(inls, idx)
        score0 = _take(sc, idx)
    if config.final_polish:
        with annotate("ransac/polish"):
            h_best, inl_best, score0 = _polish(h_best, inl_best, score0, src,
                                               tar, config, point_mask)
    h_best = h_best / h_best[2, 2]
    return RansacResult(
        h=h_best,
        inlier_mask=inl_best,
        num_inliers=torch.sum(inl_best).to(torch.int32),
        score=score0,
    )


def _polish(h_best, inl_best, score0, src, tar, config, point_mask):
    """The final geometric polish of the selected model, kept only if it
    holds its consensus: returns (h, inlier mask, score)."""
    from sks_tpu_torch.robust.polish import anneal_polish, gn_refine_h

    if config.scoring == "lmeds":
        # No fixed threshold to anneal: one weighted LM on the
        # robust-sigma consensus of the selected model.
        h_pol = gn_refine_h(h_best, src, tar, inl_best.to(src.dtype))
    else:
        h_pol = anneal_polish(
            h_best, src, tar, config.threshold, point_mask
        )
    # Report mask/score of the polished model at the *user* threshold.
    sc_p, inl_p = score_hypotheses(
        h_pol[None], src, tar, config.threshold, point_mask,
        config.scoring, config.sigma_max, config.df64_scoring,
    )
    ok = torch.isfinite(h_pol).all()
    if config.scoring != "lmeds":
        # Collapse guard: a large consensus drop means the refit left the
        # basin — keep the pre-polish model.
        ok = ok & (sc_p[0] >= 0.5 * score0)
    return (torch.where(ok, h_pol, h_best),
            torch.where(ok, inl_p[0], inl_best),
            torch.where(ok, sc_p[0], score0))


def ransac_homography(
    generator: torch.Generator | None,
    src: Tensor,
    tar: Tensor,
    config: RansacConfig = RansacConfig(),
    point_mask: Tensor | None = None,
    *,
    indices: Tensor | None = None,
) -> RansacResult:
    """Fit a homography to (N, 2) correspondences by vectorized RANSAC.

    Sample -> batched minimal solve -> score -> top-K -> IRLS refinement ->
    post-polish selection -> geometric polish.  ``config.fused`` routes the
    solve and score through :func:`ransac_homography_fused`'s kernel.

    Args:
      generator: draws the minimal sets (None: a fresh generator seeded 0 on
        ``src``'s device — deterministic, like the JAX default key).
      src, tar: (N, 2) matched points.
      config: static parameters.
      point_mask: optional (N,) bool for padded sets.
      indices: optional (B, 4) integer minimal sets used in place of the draw
        (B = ``config.num_hypotheses``).  The parity seam: feeding the indices
        ``sks_tpu.robust.ransac.sample_minimal_sets(key, N, B)`` draws makes
        this port score exactly the hypotheses the JAX package scores.

    Returns:
      RansacResult with the best model (normalized), its inliers and score.
    """
    with annotate("ransac/fit"):
        h_top, sc_top, inl_best = _eval_chunk(generator, src, tar, config,
                                              point_mask, indices)
        with annotate("ransac/tail"):
            return _refine_and_pack(h_top, sc_top, inl_best, src, tar, config,
                                    point_mask)


def fused_kernel_threshold(config: RansacConfig) -> float:
    """The squared threshold the fused kernel wants for ``config.scoring``.

    'inliers'/'msac' gate at threshold^2; 'magsac' at (k * sigma_max)^2.
    """
    if config.scoring == "magsac":
        sm = (config.sigma_max if config.sigma_max is not None
              else 3.0 * config.threshold)
        return (_MAGSAC_K * sm) ** 2
    return config.threshold * config.threshold


def ransac_homography_fused(
    generator: torch.Generator | None,
    src: Tensor,
    tar: Tensor,
    config: RansacConfig = RansacConfig(),
    point_mask: Tensor | None = None,
    *,
    indices: Tensor | None = None,
) -> RansacResult:
    """RANSAC with the fused ACA solve+score kernel on the hot path.

    All B hypotheses are solved and scored in one launch of
    ``sks_tpu_torch.kernels.aca_cuda.aca_solve_score_soa`` (its plain version
    on CPU tensors); only the 4-byte score per hypothesis reaches device
    memory.  The top-K winning minimal sets are re-solved and re-scored
    eagerly, then polished exactly like :func:`ransac_homography`.

    Constraints, as in the JAX package: solver 'aca'; scoring 'inliers',
    'msac' or 'magsac'; ``config.num_hypotheses`` a multiple of 128.
    Arguments as :func:`ransac_homography`, ``indices=`` included.
    """
    return ransac_homography(generator, src, tar, replace(config, fused=True),
                             point_mask, indices=indices)


def ransac_homography_fused_batch(
    generator: torch.Generator | Sequence[torch.Generator] | None,
    src: Tensor,
    tar: Tensor,
    config: RansacConfig = RansacConfig(),
    point_mask: Tensor | None = None,
    *,
    indices: Tensor | None = None,
) -> list[RansacResult]:
    """:func:`ransac_homography_fused` on P pairs with one kernel launch.

    The counterpart of ``jax.vmap`` over pairs around the fused fit.  Every
    pair's minimal sets are drawn first; one launch of
    ``aca_solve_score_soa`` scores all P x B hypotheses; the top-K re-score
    and the polish then run pair by pair.

    Args:
      generator: one generator, from which the pairs draw in turn (nothing
        else on the path draws from it, so the draws are those of P single
        fits in turn); or a sequence of P generators, pair i drawing from
        the i-th (``utils.streams.pair_generators``: a pair's draws then do
        not depend on the other pairs of the batch).
      src, tar: (P, N, 2) matched points.
      point_mask: optional (P, N) bool.
      indices: optional (P, B, 4) integer minimal sets in place of the draws.

    Returns:
      One :class:`RansacResult` per pair.
    """
    pairs = range(src.shape[0])
    if isinstance(generator, Sequence):
        if len(generator) != len(pairs):
            raise ValueError(f"{len(generator)} generators for "
                             f"{len(pairs)} pairs")
        gens = list(generator)
    else:
        if generator is None and indices is None:
            generator = torch.Generator(device=src.device).manual_seed(0)
        gens = [generator] * len(pairs)
    masks = [None if point_mask is None else point_mask[i] for i in pairs]
    with annotate("ransac/draw"):
        draws = [
            _fused_draw(gens[i], src[i], tar[i], config, masks[i],
                        None if indices is None else indices[i])
            for i in pairs
        ]
        if not draws:
            return []
        s_soa, t_soa, pts, pw = (torch.stack(x) for x in
                                 zip(*(kernel_in for _, kernel_in in draws)))
    with annotate("ransac/k2"):
        counts = aca_solve_score_soa(
            s_soa, t_soa, pts, fused_kernel_threshold(config),
            point_weights=pw, scoring=config.scoring,
        )
    s4, t4 = (torch.stack(x) for x in zip(*(st for st, _ in draws)))
    tensors = (counts, s4, t4, src, tar,
               *(() if point_mask is None else (point_mask,)))
    tail = partial(_fused_batch_tail, config)
    with annotate("ransac/tail"):
        if graphs.graphable(*tensors):
            h, inl, ninl, score = graphs.replay(("fused_tail", config), tail,
                                                *tensors)
        else:
            h, inl, ninl, score = tail(*tensors)
    return [RansacResult(h=h[i], inlier_mask=inl[i], num_inliers=ninl[i],
                         score=score[i]) for i in pairs]


def _fused_batch_tail(config, counts, s4, t4, src, tar, point_mask=None):
    """The tail of a fused batch, pair by pair: each pair's top-K re-score
    (:func:`_fused_top`) and :func:`_refine_and_pack`.  Nothing is read back
    and every shape is fixed, so on the card it replays as one CUDA graph
    (``utils.graphs``).  Returns the P results' fields stacked: h (P, 3, 3),
    inlier_mask (P, N), num_inliers (P,), score (P,)."""
    results = []
    for i in range(src.shape[0]):
        pm = None if point_mask is None else point_mask[i]
        top = _fused_top(counts[i], s4[i], t4[i], src[i], tar[i], config, pm)
        results.append(_refine_and_pack(*top, src[i], tar[i], config, pm))
    return tuple(torch.stack([getattr(r, f) for r in results])
                 for f in ("h", "inlier_mask", "num_inliers", "score"))


#: Chunk size of the adaptive loop from which a ``config.fused`` stage runs
#: the fused kernel (K2, then the eager re-score of its top-K) instead of the
#: eager chunk (K1, then eager scoring of every hypothesis).  Measured on an
#: NVIDIA H100 80GB HBM3, 700.00 W, by ``bench/fused_adaptive.py``: host ms
#: of one chunk to a ``synchronize``, on the schedule's size grid (256 x 4^k
#: and the cap), at N = 512 and 2,000 points.  The fused chunk costs 3-6 ms
#: of host at every size (its re-score is ~190 small launches); the eager
#: chunk 2-3 ms until its (B, N) passes outgrow that.  At N = 2,000 the
#: fused chunk loses at 4,096 (4.0 against 3.0 ms) and wins from 16,384
#: (2.8 against 8.3); at N = 512 the two tie at 16,384 (2.9 against 2.8)
#: and the fused chunk wins from 65,536 (4.1 against 8.7).  The value is the
#: smallest size from which the fused chunk is no slower at both point
#: counts (``crossover_chunk``).  That it equals the JAX package's constant
#: is a coincidence of the two-point-count rule, not a copy: the TPU value
#: was read at N = 2,000, where this card's crossover is 16,384.  Stages
#: below the value run eager chunks even with ``config.fused``.
FUSED_ADAPTIVE_MIN_CHUNK = 65536

#: Default cap on the geometric chunk growth (a distinct quantity from the
#: fused gate above).  A parameter of the schedule, kept at the JAX package's
#: value: it decides after which chunk a fit stops, so the two packages stop
#: alike only with the same cap.
ADAPTIVE_MAX_CHUNK = 131072


def _chunk_schedule(chunk0: int, max_chunks: int, growth: int,
                    chunks_per_stage: int, max_chunk: int):
    """[(chunk_size, num_chunks), ...] stages covering chunk0 * max_chunks.

    Geometric growth: ``chunks_per_stage`` chunks at each size, size x
    ``growth`` between stages, capped at ``max_chunk``; the final stage
    absorbs the remaining budget at the cap size.
    """
    total = chunk0 * max_chunks
    if growth <= 1 or max_chunks <= 1 or max_chunk <= chunk0:
        return [(chunk0, max_chunks)]
    stages = []
    c, budget = chunk0, 0
    while budget < total:
        remaining_chunks = -(-(total - budget) // c)
        n = remaining_chunks if c >= max_chunk else min(
            chunks_per_stage, remaining_chunks
        )
        stages.append((c, n))
        budget += c * n
        c = min(c * growth, max_chunk)
    return stages


def _read_flag(flag: Tensor) -> bool:
    """Read a 0-d bool tensor on the host: the adaptive loop's one
    synchronisation with the device, once a chunk."""
    return bool(flag)


def ransac_homography_adaptive(
    generator: torch.Generator | None,
    src: Tensor,
    tar: Tensor,
    config: RansacConfig = RansacConfig(),
    confidence: float = 0.99,
    max_chunks: int = 16,
    point_mask: Tensor | None = None,
    growth: int = 4,
    chunks_per_stage: int = 2,
    max_chunk: int | None = None,
    *,
    indices: Tensor | None = None,
) -> RansacResult:
    """RANSAC with confidence-based early exit (cv2 ``confidence`` semantic).

    The fixed-batch :func:`ransac_homography` sizes its budget for the
    worst-case outlier ratio; on easy problems most of that work is wasted.
    This variant evaluates hypotheses in fixed-shape chunks and stops once
    the standard RANSAC termination bound says the hypotheses drawn so far
    find an all-inlier sample with probability >= ``confidence``:

        k_needed = log(1 - confidence) / log(1 - w^4),   w = inlier ratio.

    The total draw is bounded by the stage schedule built from a budget of
    ``config.num_hypotheses * max_chunks`` hypotheses: the final stage
    absorbs the remainder at the grown chunk size, so the worst case rounds
    that budget UP to a stage boundary (e.g. 1024 x 16 schedules 26,624 —
    see :func:`_chunk_schedule`).

    Chunk sizes start at ``config.num_hypotheses`` and grow ``growth``x every
    ``chunks_per_stage`` chunks up to ``max_chunk`` (default
    ``ADAPTIVE_MAX_CHUNK``); ``growth=1`` gives a flat schedule.  With
    ``config.fused``, stages of at least ``FUSED_ADAPTIVE_MIN_CHUNK``
    hypotheses run the fused solve+score kernel and smaller ones the eager
    chunk.  The running top-K carries across chunks and stages; the
    champion's inlier ratio drives the bound.

    The JAX package decides its trip counts on the device
    (``lax.while_loop``).  Here the stop test is read on the host: this is
    the one entry point of the module that synchronises with the device, one
    boolean before each chunk through :func:`_read_flag`; everything else
    (the merge, the champion's mask) stays a ``torch.where``.  Once the bound
    is met no later stage evaluates a chunk.

    Args:
      generator, src, tar, config, point_mask: as :func:`ransac_homography`.
      confidence: the probability the bound must reach, clipped to
        [0, 1 - 1e-7].
      max_chunks: budget in chunks of ``config.num_hypotheses``.
      indices: optional (total_budget, 4) integer minimal sets for the whole
        schedule (total_budget = the sum of ``size * count`` over
        :func:`_chunk_schedule`), sliced at the running hypothesis offset as
        the PROSAC schedule is: the parity seam of the fixed-batch fits.

    Returns:
      RansacResult of the shared refine-and-polish tail on the merged top-K.
    """
    with annotate("ransac/fit"):
        n = src.shape[-2]
        dtype, device = src.dtype, src.device
        nf = (torch.sum(point_mask).to(dtype) if point_mask is not None
              else _scalar(n, src))
        chunk0 = config.num_hypotheses
        if max_chunk is None:
            max_chunk = ADAPTIVE_MAX_CHUNK
        stages = _chunk_schedule(chunk0, max_chunks, growth, chunks_per_stage,
                                 max_chunk)
        total_budget = sum(c * k for c, k in stages)
        conf = torch.clamp(_scalar(confidence, src), 0.0, 1.0 - 1e-7)

        def needed(num_inl):
            w = num_inl / torch.clamp(nf, min=1.0)
            w2 = w * w
            p_good = torch.clamp(w2 * w2, 1e-12, 1.0 - 1e-7)
            return torch.log1p(-conf) / torch.log1p(-p_good)

        # PROSAC: one global growth schedule over the worst-case budget,
        # sliced per chunk at the running hypothesis offset — later chunks
        # continue toward uniform sampling instead of re-drawing the
        # quality-concentrated head every time.
        all_sizes = (
            torch.as_tensor(prosac_prefix_sizes(n, total_budget),
                            device=device)
            if config.sampling == "prosac" and indices is None
            else None
        )
        if indices is not None:
            indices = torch.as_tensor(indices)
            if (indices.shape != (total_budget, 4)
                    or indices.is_floating_point()):
                raise ValueError(
                    f"indices must be an integer ({total_budget}, 4) tensor, "
                    f"the whole schedule's draws; got {indices.dtype} "
                    f"{tuple(indices.shape)}"
                )
            indices = indices.to(device)
        if generator is None and indices is None:
            generator = torch.Generator(device=device).manual_seed(0)
        k_cand = max(1, min(config.lo_candidates, chunk0))

        h_k = torch.full((k_cand, 3, 3), torch.nan, dtype=dtype, device=device)
        sc_k = torch.full((k_cand,), -torch.inf, dtype=dtype, device=device)
        inl = torch.zeros(n, dtype=torch.bool, device=device)
        ninl = _scalar(0.0, src)
        done = 0  # hypotheses drawn so far
        bound = None  # the last read's hypotheses needed (0-d)

        for c_s in (c for c, k in stages for _ in range(k)):
            flag = _scalar(done, src) < (bound := needed(ninl))
            with annotate("ransac/sync"):
                go = _read_flag(flag)
            count("ransac.host_reads")
            if not go:
                break  # bound met: no later stage evaluates a chunk
            cfg_s = replace(
                config,
                num_hypotheses=c_s,
                fused=config.fused and c_s >= FUSED_ADAPTIVE_MIN_CHUNK,
            )
            part = slice(done, done + c_s)
            h_c, sc_c, inl_c = _eval_chunk(
                generator, src, tar, cfg_s, point_mask,
                None if indices is None else indices[part],
                None if all_sizes is None else all_sizes[part],
            )
            # Merge running top-K with this chunk's top-K.
            sc_all = torch.cat([sc_k, sc_c])
            h_all = torch.cat([h_k, h_c])
            idx = _top_k(sc_all, k_cand)
            better = sc_c[0] > sc_k[0]
            inl = torch.where(better, inl_c, inl)
            ninl = torch.where(better, torch.sum(inl_c).to(dtype), ninl)
            h_k, sc_k = h_all[idx], sc_all[idx]
            done += c_s

        if bound is not None:
            count("ransac.bound", bound)

        # All-or-nothing fallback per candidate: a partially-finite model must
        # not be blended elementwise with the identity.
        finite = _all_finite(h_k)
        h_top = torch.where(finite[:, None, None], h_k,
                            torch.eye(3, dtype=dtype, device=device))
        with annotate("ransac/tail"):
            return _refine_and_pack(h_top, sc_k, inl, src, tar, config,
                                    point_mask)
