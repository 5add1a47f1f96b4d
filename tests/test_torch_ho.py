"""Port parity and instruments of the HO kernels (K4-HO, K5-ho).

The HO kernels' equality with their plain versions is held on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Here, on the CPU:

* the adversarial 4-point pairs (tests/torch_parity.py::adversarial_quads:
  collinear, repeated and zero-size quads, squares that underflow or
  overflow, NaN and infinity) go through the JAX package's
  ``ho_core(eig_method="jacobi")``, jitted, and its Pallas kernel
  ``ho_solve_soa`` in interpret mode, and through the port's plain version of
  K4-HO: NaN and non-finite values in the same places, finite values within
  2e-4 after ``normalize_h('fro')`` (the HO tolerance of
  tests/test_torch_kernels.py: XLA on the CPU contracts multiply-adds).  Two
  kinds of case are held to less, and say why: a singular G (``collinear``,
  ``repeated``) leaves an H that is rounding noise on both sides, finite in
  the same places and different in value; and XLA's CPU code flushes
  subnormals to zero where PyTorch keeps them (``subtiny``), so the port is
  held to JAX there with ``torch.set_flush_denormal(True)``;
* the algebra that lets the kernels' rotation drop two multiplications and
  two range checks (``csrc/baselines.cuh::Rotation``) is checked in
  float32 on special values;
* the pure-Python parts of the HO ablation (``bench/ho_ablation.py``), of the
  instruction counter (``bench/sass.py``) and the operation counts that the
  HO kernels' bounds rest on.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import adversarial_quads, fro, from_tiles, to_np, to_tiles

from sks_tpu.kernels import baselines_pallas as jb
from sks_tpu.ops.ho import ho_core as jax_ho_core

from sks_tpu_torch.bench import ho_ablation, roofline, sass
from sks_tpu_torch.kernels import FP64_SOLVE_KERNELS, SOLVE_KERNELS, _build
from sks_tpu_torch.kernels import baselines_cuda as tb
from sks_tpu_torch.kernels._soa import to_soa

T = torch.from_numpy

CASES = ("general", "collinear", "collinear3", "collinear_y", "repeated",
         "point", "point_tar", "subtiny", "small", "large", "small_large",
         "identity", "nan", "nan_tar", "inf", "inf_tar")
#: G is singular up to rounding: H is rounding noise in both packages.
ILL_CONDITIONED = ("collinear", "repeated")
PER_CASE = 8


@pytest.fixture(scope="module")
def adversarial():
    """The 128 adversarial pairs through both packages: (labels, port,
    port with subnormals flushed, {reference name: JAX output}), each
    output (9, 128) float32."""
    src, tar, labels = adversarial_quads(0, PER_CASE)
    assert tuple(labels[::PER_CASE]) == CASES
    s, t = to_soa(T(src)), to_soa(T(tar))
    port = to_np(tb.ho_solve_soa(s, t))
    # XLA's CPU code runs with subnormals flushed to zero.
    torch.set_flush_denormal(True)
    try:
        flushed = to_np(tb.ho_solve_soa(s, t))
    finally:
        torch.set_flush_denormal(False)
    with pltpu.force_tpu_interpret_mode():
        pallas = from_tiles(jb.ho_solve_soa(to_tiles(s), to_tiles(t), tile=1))
    core = jax.jit(lambda a, b: jnp.stack(jax_ho_core(
        *[a[i] for i in range(8)], *[b[i] for i in range(8)],
        eig_method="jacobi")))
    refs = {"pallas": pallas, "core": np.asarray(core(to_np(s), to_np(t)))}
    return labels, port, flushed, refs


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("reference", ["pallas", "core"])
def test_ho_plain_matches_jax_on_adversarial_quads(adversarial, reference,
                                                   case):
    labels, port, flushed, refs = adversarial
    cols = [i for i, name in enumerate(labels) if name == case]
    ours = (flushed if case == "subtiny" else port)[:, cols]
    theirs = refs[reference][:, cols]
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(theirs))
    finite = np.isfinite(ours).all(0)
    if case not in ILL_CONDITIONED and finite.any():
        np.testing.assert_allclose(
            fro(ours.T.reshape(-1, 3, 3)[finite]),
            fro(theirs.T.reshape(-1, 3, 3)[finite]), atol=2e-4)


def test_adversarial_quads_reach_the_branches(adversarial):
    """The set does what it is for: whole-NaN outputs where the normalization
    or G's inverse breaks down, finite ones elsewhere, and a subnormal-size
    quad that tells the two packages' CPU arithmetic apart."""
    labels, port, flushed, _ = adversarial
    nan = {c: np.isnan(port[:, [i for i, n in enumerate(labels) if n == c]])
           for c in CASES}
    for case in ("collinear_y", "point", "large", "nan", "nan_tar", "inf",
                 "inf_tar"):
        assert nan[case].all(), case
    for case in ("general", "collinear", "collinear3", "repeated",
                 "point_tar", "small", "identity"):
        assert not nan[case].any(), case
    assert nan["small_large"].any() and not nan["small_large"].all()
    assert not nan["subtiny"].all()
    assert np.isnan(flushed[:, [i for i, n in enumerate(labels)
                                if n == "subtiny"]]).all()


def _ieee_angle(app, aqq, apq):
    """The rotation as ``jacobi_smallest_col_core`` writes it, float32."""
    tiny = torch.finfo(torch.float32).tiny
    tau = (aqq - app) * 0.5
    sgn = torch.where(tau >= 0, 1.0, -1.0)
    hyp = torch.sqrt(tau * tau + apq * apq + tiny)
    t = sgn * apq / (sgn * tau + hyp)
    return tau, hyp, sgn, t


def test_rotation_shortcuts_are_exact_on_special_values():
    """What ``csrc/baselines.cuh::Rotation`` rests on, for every triple of
    the values its card check uses: ``sgn * tau + hyp`` is ``|tau| + hyp``,
    ``sgn * apq`` is a sign flip, and ``t * t + 1`` lies in [1, 2] or is NaN,
    so the second square root and the reciprocal never leave [1, 2]."""
    v = T(ho_ablation.angle_check_values())
    assert torch.isnan(v).any() and torch.isinf(v).any() and (v == 0).any()
    assert ((v != 0) & (v.abs() < torch.finfo(torch.float32).tiny)).any()
    app, aqq, apq = torch.meshgrid(v, v, v, indexing="ij")
    tau, hyp, sgn, t = _ieee_angle(app, aqq, apq)

    def same(a, b):
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    assert same(sgn * tau + hyp, tau.abs() + hyp)
    flipped = torch.where(tau >= 0, apq, -apq)
    assert same(sgn * apq, flipped)
    assert torch.equal(torch.signbit(sgn * apq)[~torch.isnan(apq)],
                       torch.signbit(flipped)[~torch.isnan(apq)])
    assert same(t, flipped / (tau.abs() + hyp))
    y = t * t + 1.0
    assert bool((torch.isnan(y) | ((y >= 1.0) & (y <= 2.0))).all())
    assert bool((y == 2.0).any()) and bool((y == 1.0).any())
    # The denominator that ``DivTiny`` divides by is positive or NaN.
    den = tau.abs() + hyp
    assert bool((torch.isnan(den) | (den >= 2.0 ** -64)).all())


def test_ho_ablation_tags_have_their_symbols():
    """Every tag of ``_build.HO_ABLATIONS`` is exported once by a source of
    ``csrc/ablation/``, float64 instances by the float64 macro, and the
    sources export no HO instance that the registry lacks."""
    text = "".join(p.read_text() for p in _build._sources("ablation"))
    exported = re.findall(r"SKS_EXPORT_HO_ABLATION(64)?\((\w+),", text)
    assert sorted(tag for _, tag in exported) == sorted(_build.HO_ABLATIONS)
    assert len(set(_build.HO_ABLATIONS)) == len(_build.HO_ABLATIONS)
    for wide, tag in exported:
        assert bool(wide) == tag.startswith("f64_"), tag
    assert not set(_build.HO_ABLATIONS) & set(_build.NDLT_ABLATIONS)
    assert 'extern "C" int sks_ho_abl_angle_check(' in text
    # The instruments are built on demand: no source of the kernel library
    # includes them, and the production headers hold no instrument.
    for path in _build._sources():
        assert "ablation/" not in path.read_text()
    for header in ("baselines.cuh", "soa.cuh"):
        assert "Ablation" not in (_build._CSRC / header).read_text()


def test_which_ho_ablation_tags_compute_ho():
    computes = {t for t in _build.HO_ABLATIONS if ho_ablation.computes_ho(t)}
    assert computes == {
        "before", "roll_s10", "roll_abs", "roll_unit", "roll_div64",
        "roll_tiny64", "tiny_t64", "tiny_t256", "f64_before", "f64_roll",
        "f64_unit", "f64_unit_mb4", "f64_unit_mb5", "f64_tiny64_mb4",
        "f64_tiny", "f64_tiny_mb3", "f64_tiny_mb4", "f64_tiny_mb5",
        "f64_tiny_t64_mb7", "f64_tiny_t64_mb8", "f64_tiny_t64_mb9"}
    # Fewer sweeps, no eigensolver, approximate arithmetic, half of K5-ho.
    assert set(_build.HO_ABLATIONS) - computes == {
        "unroll_s0", "unroll_s2", "unroll_s5", "noeig", "roll_s2", "roll_s5",
        "roll_approx", "f64_seed_only", "f64_refine_only"}


def test_ho_ablation_needs_a_card_and_known_tags():
    s = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="unknown ablation"):
        ho_ablation.ablation_solve("regs_roll", s, s)
    with pytest.raises(ValueError, match="CUDA device only"):
        ho_ablation.ablation_solve("before", s, s)
    with pytest.raises(TypeError):
        ho_ablation.ablation_solve("f64_before", s, s)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a card"):
            ho_ablation.run_ablation(batch=4)
        with pytest.raises(RuntimeError, match="needs a card"):
            ho_ablation.angle_check()


def test_ho_operation_counts_behind_the_bounds():
    """``bench/roofline.py`` on the plain versions: K4-HO is 2,859 float32
    operations a hypothesis; K5-ho is 793 float64 (the core, the LDL^T solves
    and the 9 divisions by h22) and 852 float32 (its 4-sweep Jacobi seed: 71
    a rotation), each held to its own peak rate."""
    assert roofline.solve_ops(SOLVE_KERNELS["ho"].plain)["float32"] == 2859
    ho64 = roofline.solve_ops(FP64_SOLVE_KERNELS["ho"].plain, torch.float64)
    assert (ho64["float64"], ho64["float32"]) == (793, 852)
    assert 852 == 4 * 3 * 71
    b = 1 << 20
    ms4, by4 = roofline.bound_ms(100 * b, {"float32": 2859 * b})
    ms5, by5 = roofline.bound_ms(200 * b, {"float64": 793 * b,
                                           "float32": 852 * b})
    assert by4 == "operations" and abs(ms4 - 0.0447) < 1e-4
    assert by5 == "bytes" and abs(ms5 - 0.0626) < 1e-4


_LISTING = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/               @P0 EXIT ;
        /*0020*/                   MUFU.RSQ R2, R4 ;
        /*0030*/                   FFMA R0, -R0, R2, R0 ;
        /*0040*/              @!P0 BRA 0x20 ;
        /*0050*/                   MUFU.RCP64H R7, R5 ;
        /*0060*/               @P1 BRA 0x80 ;
        /*0070*/                   CALL.REL.NOINC 0xa0 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90;
        /*00a0*/                   MUFU.RCP64H R3, R5 ;
        /*00b0*/                   RET.REL.NODEC R2 0x0 ;
"""


def test_sass_counts_what_a_thread_executes():
    ops, loops = sass.parse_kernel(_LISTING)
    assert ops["MUFU"] == 3 and ops["CALL"] == 1 and ops["RET"] == 1
    assert loops == [("0x20", 3), ("0x90", 1)]
    assert sass.mufu_kinds(_LISTING) == {"RSQ": 1, "RCP64H": 2}
    # Up to the last EXIT: 9 instructions; the loop of 3 run 10 times adds 27;
    # the slow path behind the EXIT and the trailing self-branch never count.
    assert sass.executed_instructions(_LISTING) == 9
    assert sass.executed_instructions(_LISTING, trips=10) == 9 + 9 * 3


def test_instruction_limit_is_instructions_over_the_schedulers():
    # 2^20 threads are 32,768 warps; 528 schedulers start one instruction a
    # clock each: 3,900 instructions a thread need 0.138 ms at 1.755 GHz.
    ms = sass.instruction_limit_ms(3900, 1 << 20)
    assert abs(ms - 3900 * 32768 / 528 / 1.755e9 * 1e3) < 1e-12
    assert abs(ms - 0.1379) < 1e-4
    assert sass.instruction_limit_ms(100, 33) == sass.instruction_limit_ms(100, 64)
    assert sass.instruction_limit_ms(3900, 1 << 20, 1.98e9) < ms
