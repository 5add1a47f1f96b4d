"""Fixed-shape vectorized RANSAC for homography fitting.

Port of ``sks_tpu/robust/ransac.py``: a fixed batch of B hypotheses is drawn,
solved with the batched minimal solver, scored against every correspondence,
and the top-K candidates are refined and selected — no data-dependent loop,
and no host synchronisation anywhere on the path (every accept/reject is a
``torch.where``, every pick an on-device index).  Degenerate hypotheses
(collinear samples, duplicate indices, non-finite H) score -1 instead of being
branched on.

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

from dataclasses import dataclass

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
from sks_tpu_torch.ops import SOLVERS_H, aca_valid_mask, sks_valid_mask
from sks_tpu_torch.ops.fp64 import residual2_fp64
from sks_tpu_torch.ops.ndlt import ndlt_h

__all__ = [
    "RansacConfig",
    "RansacResult",
    "fused_kernel_threshold",
    "magsac_weights",
    "ransac_homography",
    "ransac_homography_adaptive",
    "ransac_homography_fused",
    "ransac_homography_fused_batch",
    "sample_minimal_sets",
    "score_hypotheses",
]

#: MAGSAC++ residual-space dimensionality: the symmetric transfer error is a
#: 4-vector (forward + backward 2D reprojection), so nu = 4 and the 0.99
#: chi^2_4 quantile gives tau(sigma) = k * sigma with k = sqrt(13.2767).
_MAGSAC_NU = 4.0
_MAGSAC_K = 3.6437

_ADAPTIVE_LATER = (
    "the confidence early-exit loop (ransac_homography_adaptive) is not "
    "ported yet; it comes with PROSAC and the port's own fused-versus-eager "
    "crossover (ROADMAP.md Queue A, next item)"
)
_PROSAC_LATER = (
    "sampling='prosac' is not ported yet; it comes with "
    "ransac_homography_adaptive (ROADMAP.md Queue A, next item)"
)


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

    ``sampling='prosac'`` is not ported yet and raises
    ``NotImplementedError``.  ``df64_scoring`` keeps the JAX package's name;
    here it scores in native float64.
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
    # Requires solver='aca', scoring in {'inliers','msac','magsac'},
    # num_hypotheses % 128 == 0.
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


def _sample_chunk(generator, n, config, point_mask=None):
    if config.sampling == "prosac":
        raise NotImplementedError(_PROSAC_LATER)
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


def _minimal_sets(generator, src, config, point_mask, indices):
    """The (B, 4) index tuples of one batch: ``indices`` if given, else drawn."""
    b = config.num_hypotheses
    if indices is None:
        if generator is None:
            generator = torch.Generator(device=src.device).manual_seed(0)
        idx = _sample_chunk(generator, src.shape[-2], config, point_mask)
    else:
        idx = torch.as_tensor(indices)
        if idx.shape != (b, 4) or idx.is_floating_point():
            raise ValueError(
                f"indices must be an integer ({b}, 4) tensor; got "
                f"{idx.dtype} {tuple(idx.shape)}"
            )
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
    """
    pm = None if point_mask is None else point_mask.to(src.dtype)
    sm = sigma_max if sigma_max is not None else 3.0 * threshold
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


def _fused_draw(generator, src, tar, config, point_mask, indices=None):
    """Check a fused-path config and draw one pair's batch: the minimal sets
    ``(s4, t4)`` and the fused kernel's ``(src, tar, pts, weights)``."""
    if config.solver != "aca":
        raise ValueError("the fused path is ACA-only")
    if config.scoring not in ("inliers", "msac", "magsac"):
        raise ValueError(f"the fused path cannot score {config.scoring!r}")
    b = config.num_hypotheses
    if b % 128:
        raise ValueError("num_hypotheses must be a multiple of 128 on the "
                         f"fused path, as in the JAX package; got {b}")
    idx = _minimal_sets(generator, src, config, point_mask, indices)
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
    # The kernel ordered candidates by its own scores; the eager re-score can
    # disagree near ties, and _refine_and_pack wants best first.  A stable
    # ascending sort of the negation, as jnp.argsort(-sc_top).
    order = torch.sort(-sc_top, stable=True).indices
    return h_top[order], sc_top[order], _take(inl, order[0])


def _eval_chunk_fused(generator, src, tar, config, point_mask, indices=None):
    """Fused-kernel twin of :func:`_eval_chunk` (same contract).

    All B hypotheses are solved and scored in one kernel launch; only the
    top-K winning minimal sets are re-solved and re-scored on the eager path.
    """
    (s4, t4), (s_soa, t_soa, pts, pw) = _fused_draw(
        generator, src, tar, config, point_mask, indices)
    counts = aca_solve_score_soa(
        s_soa, t_soa, pts, fused_kernel_threshold(config), point_weights=pw,
        scoring=config.scoring,
    )
    return _fused_top(counts, s4, t4, src, tar, config, point_mask)


def _eval_chunk(generator, src, tar, config, point_mask, indices=None):
    """Sample + solve + score one fixed-shape batch; return its top-K."""
    if config.fused:
        return _eval_chunk_fused(generator, src, tar, config, point_mask,
                                 indices)
    idx = _minimal_sets(generator, src, config, point_mask, indices)
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
        h_pol = _irls_refine(
            h_top, src, tar, config.refine_iters, config.threshold,
            point_mask, config.scoring, config.sigma_max, config.df64_scoring,
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
        h_best = torch.where(ok, h_pol, h_best)
        inl_best = torch.where(ok, inl_p[0], inl_best)
        score0 = torch.where(ok, sc_p[0], score0)
    h_best = h_best / h_best[2, 2]
    return RansacResult(
        h=h_best,
        inlier_mask=inl_best,
        num_inliers=torch.sum(inl_best).to(torch.int32),
        score=score0,
    )


def _check_ported(config: RansacConfig) -> None:
    if config.sampling == "prosac":
        raise NotImplementedError(_PROSAC_LATER)


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
    _check_ported(config)
    h_top, sc_top, inl_best = _eval_chunk(generator, src, tar, config,
                                          point_mask, indices)
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
    _check_ported(config)
    h_top, sc_top, inl_best = _eval_chunk_fused(generator, src, tar, config,
                                                point_mask, indices)
    return _refine_and_pack(h_top, sc_top, inl_best, src, tar, config,
                            point_mask)


def ransac_homography_fused_batch(
    generator: torch.Generator | None,
    src: Tensor,
    tar: Tensor,
    config: RansacConfig = RansacConfig(),
    point_mask: Tensor | None = None,
    *,
    indices: Tensor | None = None,
) -> list[RansacResult]:
    """:func:`ransac_homography_fused` on P pairs with one kernel launch.

    The counterpart of ``jax.vmap`` over pairs around the fused fit.  Every
    pair's minimal sets are drawn first, pair after pair from the one
    ``generator`` (nothing else on the path draws from it, so the draws are
    those of P single fits in turn); one launch of
    ``aca_solve_score_soa`` scores all P x B hypotheses; the top-K re-score
    and the polish then run pair by pair.

    Args:
      src, tar: (P, N, 2) matched points.
      point_mask: optional (P, N) bool.
      indices: optional (P, B, 4) integer minimal sets in place of the draws.

    Returns:
      One :class:`RansacResult` per pair.
    """
    _check_ported(config)
    if generator is None and indices is None:
        generator = torch.Generator(device=src.device).manual_seed(0)
    pairs = range(src.shape[0])
    masks = [None if point_mask is None else point_mask[i] for i in pairs]
    draws = [
        _fused_draw(generator, src[i], tar[i], config, masks[i],
                    None if indices is None else indices[i])
        for i in pairs
    ]
    if not draws:
        return []
    s_soa, t_soa, pts, pw = (torch.stack(x) for x in
                             zip(*(kernel_in for _, kernel_in in draws)))
    counts = aca_solve_score_soa(
        s_soa, t_soa, pts, fused_kernel_threshold(config), point_weights=pw,
        scoring=config.scoring,
    )
    results = []
    for i, ((s4, t4), _) in enumerate(draws):
        top = _fused_top(counts[i], s4, t4, src[i], tar[i], config, masks[i])
        results.append(_refine_and_pack(*top, src[i], tar[i], config,
                                        masks[i]))
    return results


def ransac_homography_adaptive(*args, **kwargs) -> RansacResult:
    """RANSAC with confidence-based early exit — not ported yet."""
    raise NotImplementedError(_ADAPTIVE_LATER)
