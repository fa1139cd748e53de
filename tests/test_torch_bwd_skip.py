"""The exact skip of ``smooth_bwd_step`` and ``clear_bwd``, and the row
layout of ``smooth_bwd_step`` (``csrc/bounce_smooth_sub.cu``,
``csrc/smooth_parts.cu``).

A warp of either kernel passes a shadow sphere that reaches none of its
rays: the sphere is the ray's winner (its own), or its shadow sigmoid
``sig(sharpness * disc)`` is exactly 0.  Here, on seeded scenes in f32 and
f64, every lane-sphere pair the test rejects contributes exactly +-0 to
every Phase C term of the plain versions, and the plain versions with
those pairs left out are bitwise the plain versions.  Then the launch
arithmetic and the row bytes beside the column layout's, the Python
constants against the CUDA source's, the sigmoid's zero edge, and the
split script's patches.  No JAX, no kernel: the kernels run on the card
(``chip_smoke.py``).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from python_ray_tracer_tpu_torch import RenderConfig  # noqa: E402
from python_ray_tracer_tpu_torch.benchmarks import smooth_bwd_split  # noqa: E402
from python_ray_tracer_tpu_torch.benchmarks.splits import layout_of  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.models.scenes import random_spheres_scene  # noqa: E402
from python_ray_tracer_tpu_torch.ops import _build  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss  # noqa: E402
from python_ray_tracer_tpu_torch.ops import smooth_parts as sp  # noqa: E402

DTYPES = (torch.float32, torch.float64)
SMS = 132  # an H100 SXM's streaming multiprocessors


def _step_args(dtype):
    """smooth_bwd_step's arguments on the first bounce of random_spheres_scene(64)
    at 32x16, seeded cotangents on all five outputs (numpy, seed 12)."""
    scene = random_spheres_scene(64, 32, 16, dtype=dtype)
    cfg = RenderConfig(max_depth=1, dtype=dtype, visibility="smooth", use_pallas=True)
    o, d, tables, kw = bss._kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg)
    kw.pop("depth")
    n = d.shape[1]
    ones = torch.ones(n, dtype=dtype)
    state = (o, d, ones, ones, torch.zeros_like(d))
    fwd = bss.smooth_fwd_step_plain(*state, *tables, **kw)
    rng = np.random.default_rng(12)
    cots = [torch.as_tensor(rng.uniform(-0.5, 0.5, t.shape), dtype=dtype) for t in fwd[:5]]
    return (*state[:4], *fwd[5:8], *tables, *cots), kw


@pytest.fixture(scope="module", params=DTYPES, ids=("f32", "f64"))
def step_case(request):
    args, kw = _step_args(request.param)
    return args, kw, bss.smooth_bwd_step_plain(*args, **kw)


def _reached(f, k, c, r, fn, faraway):
    """The skip's test on every lane: the sphere is not the lane's winner and
    its tier's shadow sigmoid is not exactly 0."""
    _, disc, _, _, _ = fn(f.p_n, f.L, c, r, faraway)
    return (f.idx != k) & (bss.sig(f.sharp_s * disc) != 0)


def test_phase_c_terms_of_rejected_pairs_are_exact_zeros(step_case, monkeypatch):
    """Every Phase C term (g_pn_s's two, g_L's, the table row's four) of a
    lane-sphere pair the skip rejects is exactly +-0, in the plain version
    smooth_bwd_step_plain runs; and the test rejects nearly every pair."""
    args, kw, _ = step_case
    real = bss.shadow_terms
    seen = {"pairs": 0, "reached": 0, "nonzero_rejected": 0}

    def checked(f, k, c, r, fn, g_cc, faraway, active=None):
        terms = real(f, k, c, r, fn, g_cc, faraway, active)
        reached = _reached(f, k, c, r, fn, faraway)
        seen["pairs"] += reached.numel()
        seen["reached"] += int(reached.sum())
        for t in (x for group in terms for x in group):
            seen["nonzero_rejected"] += int((t[~reached] != 0).sum())
        return terms

    monkeypatch.setattr(bss, "shadow_terms", checked)
    bss.smooth_bwd_step_plain(*args, **kw)
    assert seen["pairs"] == 64 * 32 * 16
    assert seen["nonzero_rejected"] == 0
    assert 0 < seen["reached"] < 0.05 * seen["pairs"]


def test_plain_step_without_rejected_pairs_is_bitwise_the_plain_step(step_case, monkeypatch):
    """The plain version with every rejected pair's terms left out (+0 in
    place of the term) gives the plain version's outputs bitwise."""
    args, kw, want = step_case
    real = bss.shadow_terms

    def skipping(f, k, c, r, fn, g_cc, faraway, active=None):
        reached = _reached(f, k, c, r, fn, faraway)
        zero = torch.zeros_like(g_cc)
        return tuple([torch.where(reached, t, zero) for t in group]
                     for group in real(f, k, c, r, fn, g_cc, faraway, active))

    monkeypatch.setattr(bss, "shadow_terms", skipping)
    got = bss.smooth_bwd_step_plain(*args, **kw)
    for name, g, w in zip(("g_o", "g_d", "g_thr", "g_alive", "g_geom", "g_mat", "g_consts"), got, want):
        assert torch.equal(g, w), name


def _clear_args(dtype):
    """clear_bwd's arguments from the first bounce of the same scene: the
    nudged hit points, the unit directions to the light, each lane's winner,
    the plain shadow product and a seeded cotangent (numpy, seed 13)."""
    args, kw = _step_args(dtype)
    f = bss.fwd_sub_math(tuple(args[0]), tuple(args[1]), args[2], args[3], *args[7:10],
                         faraway=kw["faraway"], s_cheap=kw["s_cheap"], sharp_e=kw["sharp_e"], sharp_s=kw["sharp_s"])
    o = torch.stack(f.p_n, dim=1).contiguous()
    d = torch.stack(f.L, dim=1).contiguous()
    geom = args[7]
    ckw = dict(faraway=kw["faraway"], sharpness=kw["sharp_s"], s_cheap=kw["s_cheap"])
    self_idx = f.idx.to(torch.int32)
    clear = sp.clear_fwd_plain(o, d, geom, self_idx, **ckw)
    g_clear = torch.as_tensor(np.random.default_rng(13).uniform(-0.5, 0.5, clear.shape), dtype=dtype)
    return (o, d, geom, self_idx, clear, g_clear), ckw


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
def test_clear_bwd_rejected_pairs_are_exact_zeros_and_can_be_left_out(dtype):
    """clear_bwd_plain's per-sphere terms (g_o's, g_d's, the row's) are
    exactly +-0 on every pair the skip rejects (the lane's own sphere, or a
    shadow sigmoid of exactly 0); summed with those pairs left out, the
    outputs are bitwise clear_bwd_plain's."""
    (o, d, geom, self_idx, clear, g_clear), ckw = _clear_args(dtype)
    go, gd, rows, reached = sp.clear_terms(o, d, geom, self_idx, g_clear * clear, **ckw)
    assert 0 < int(reached.sum()) < 0.05 * reached.numel()
    for t in (*go, *gd, *rows):
        assert int((t.expand_as(reached)[~reached] != 0).sum()) == 0
    want = sp.clear_bwd_plain(o, d, geom, self_idx, clear, g_clear, **ckw)
    kept = [torch.where(reached, t, torch.zeros_like(t)) for t in (*go, *gd, *rows)]
    got = (torch.stack([x.sum(1) for x in kept[:3]], dim=1), torch.stack([x.sum(1) for x in kept[3:6]], dim=1),
           torch.zeros_like(geom) + torch.stack([x.sum(0) for x in kept[6:]], dim=1))
    for name, g, w in zip(("g_o", "g_d", "g_geom"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("spheres,width,height,rows,row_bytes,column_bytes", [
    (8192, 256, 144, 288, 179_324_928, 868_299_264),  # row 7: the 8192-sphere L2 step
    (3, 960, 540, 4050, 1_182_600, 1_409_024),  # row 9: the 3-sphere depth-1 loss
    (512, 960, 540, 4050, 157_852_800, 193_216_512),  # a sphere shard's table at the shard's frame
])
def test_step_rows_beside_the_column_layout(spheres, width, height, rows, row_bytes, column_bytes):
    """One row a CTA of 4 ray-warps (at most 4096 rows), (19 S + 16) values
    a row, in place of one (23 S + 17)-value column a warp (at most 4096)."""
    n = width * height
    assert bss.step_rows(n) == rows
    assert bss.step_rows_bytes(n, spheres, torch.float32) == row_bytes
    assert bss.partials_bytes(n, spheres, torch.float32) == column_bytes
    assert row_bytes == rows * (19 * spheres + 16) * 4
    ray_warps = -(-n // 32)
    rounds = -(-ray_warps // (rows * bss.STEP_RAY_WARPS))
    assert rows * bss.STEP_RAY_WARPS * rounds >= ray_warps > rows * bss.STEP_RAY_WARPS * (rounds - 1)
    if spheres == 8192:  # one round, 2.2 CTAs of 128 an SM on an H100
        assert rounds == 1 and rows > SMS


def test_clear_bwd_launch_arithmetic():
    """clear_bwd at row 20's shape (a 512-sphere shard at 960x540): 2025
    CTAs of 256, one (4 S)-value column of partials a CTA, as before."""
    n, s = 960 * 540, 512
    blocks = -(-n // 256)
    assert blocks == 2025
    assert 4 * s * blocks * 4 == 16_588_800


def test_step_rows_refuse_no_rays():
    with pytest.raises(ValueError, match="no rays"):
        bss.step_rows(0)


def _consts(text: str) -> dict[str, str]:
    return dict(re.findall(r"constexpr int (kStep\w+) = (\w+);", text))


def test_python_constants_mirror_the_source():
    text = (_build.CSRC / "bounce_smooth_sub.cu").read_text()
    consts = _consts(text)
    assert (int(consts["kStepRayWarps"]), int(consts["kStepSplit"]), int(consts["kStepMaxRows"])) == (
        bss.STEP_RAY_WARPS, bss.STEP_SPLIT, bss.STEP_MAX_ROWS)
    assert consts["kStepChunk"] == "kWarp" and consts["kStepMat"] == "kAdjMat"
    assert bss.STEP_THREADS == bss.STEP_RAY_WARPS * bss.STEP_SPLIT * 32
    assert re.search(r"constexpr int kAdjMat = (\d+);", (_build.CSRC / "smooth_math.cuh").read_text()).group(1) == str(
        bss.STEP_MAT)
    assert re.search(r"constexpr int kThreads = (\d+);", (_build.CSRC / "smooth_parts.cu").read_text()).group(1) == "256"


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
def test_sigmoid_zero_edge(dtype):
    """smooth_math.cuh's sig_is_zero answers without the sigmoid below lo
    (exactly 0) and above hi (not 0), and calls it between: torch's sigmoid,
    the kernels' form, agrees on both sides of the band and within it."""
    text = (_build.CSRC / "smooth_math.cuh").read_text()
    name = "float" if dtype == torch.float32 else "double"
    lo, hi = (float(v) for v in re.search(
        rf"struct SigEdge<{name}> \{{\n  static constexpr {name} lo = (-?[\d.]+)f?, hi = (-?[\d.]+)f?;", text).groups())
    below = torch.linspace(lo - 1e4, lo, 2001, dtype=dtype)
    above = torch.linspace(hi, 0.0, 2001, dtype=dtype)
    band = torch.linspace(lo, hi, 2001, dtype=dtype)
    assert torch.all(torch.sigmoid(below) == 0)
    assert torch.all(torch.sigmoid(above) != 0)
    s = torch.sigmoid(band)
    assert bool((s == 0).any()) and bool((s != 0).any())  # the edge lies inside the band


def test_split_patches_apply_once_to_the_source():
    """Every variant of the split script patches the shipped sources exactly
    once (a stale pattern would fail on the card, after the builds)."""
    package = _build.CSRC.parent
    assert layout_of(package, smooth_bwd_split.LAYOUTS) == "rows"
    layout = smooth_bwd_split.LAYOUTS["rows"]
    for name, patches in layout["stubs"].items():
        for file, pattern, replacement in layout["common"] + patches:
            _, n = re.subn(pattern, replacement, (package / file).read_text(), flags=re.DOTALL)
            assert n == 1, name
    # The column layout's marker is the parent's smooth_bwd_step signature.
    step_src = (package / smooth_bwd_split.STEP_SRC).read_text()
    assert smooth_bwd_split.LAYOUTS["columns"]["markers"][0][1] not in step_src


def test_ptxas_report_reads_both_kernels():
    """Both layouts' smooth_bwd_step (with and without kStaged) and clear_bwd."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115smooth_bwd_stepIfLb0ELb1ELb0EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115smooth_bwd_stepIfLb0ELb1ELb0EEEvPKT_",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 440 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115smooth_bwd_stepIdLb1ELb1EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 255 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19clear_bwdIdLb0EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 80 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111reduce_rowsIfEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
    ])
    assert smooth_bwd_split.ptxas_report(log) == {
        "smooth_bwd_step f32 staged": {"spill_stores": 8, "spill_loads": 12, "registers": 168},
        "smooth_bwd_step f64 glossy atlas": {"registers": 255},
        "clear_bwd f64": {"registers": 80},
    }
