"""The skips of ``train_deep`` and of ``smooth_nearest_parts``
(``csrc/bounce_smooth_sub.cu``, ``csrc/smooth_parts.cu``).

``train_deep`` from STEP_SKIP_MIN_CHEAP cheap-tier spheres on leaves out of
its winner sweeps and shadow products the cheap-tier spheres a warp's
bounds show cannot change them (``smooth_math.cuh`` ``SkipAll``, as
``smooth_fwd_step`` does) and passes in Phase C a sphere that reaches no
lane of a warp (``phase_c_tier``, as ``smooth_bwd_step`` does);
``smooth_nearest_parts`` walks a shard's cheap tier under the same
winner rules.  Here, on ``inverse_task_scene(64)`` at 64x32, depth 3, mirror
and glossy, f32 and f64: the plain versions with the skips are bitwise the
plain versions; on every bounce of the chain no pair the rules reject could
change an output (a winner pair is a miss with its disc at most the lane's
dmax before its chunk, a shadow pair has a sigmoid of exactly 0, a Phase C
pair adds exactly +-0); the nearest sweep's skip is bitwise on the chain's
rays and on the edge fans of ``test_torch_cs_skip.py`` and
``test_torch_fwd_step_skip.py``; the wrappers take ``skip`` on CPU tensors;
train_deep's row bytes, the constants against the source and the split
script's patches.  No JAX, no kernel: the kernels run on the card
(``chip_smoke.py``).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from python_ray_tracer_tpu_torch import RenderConfig  # noqa: E402
from python_ray_tracer_tpu_torch.benchmarks import train_deep_split  # noqa: E402
from python_ray_tracer_tpu_torch.benchmarks.splits import layout_of  # noqa: E402
from python_ray_tracer_tpu_torch.camera import ray_directions_t  # noqa: E402
from python_ray_tracer_tpu_torch.models.scenes import inverse_task_scene  # noqa: E402
from python_ray_tracer_tpu_torch.ops import _build  # noqa: E402
from python_ray_tracer_tpu_torch.ops import bounce_smooth_sub as bss  # noqa: E402
from python_ray_tracer_tpu_torch.ops import intersect_fused as f  # noqa: E402
from python_ray_tracer_tpu_torch.ops import smooth_parts as sp  # noqa: E402

from .test_torch_cs_skip import _fans  # noqa: E402
from .test_torch_fwd_step_skip import _dmax_fans, _shadow_misses, _winner_misses  # noqa: E402

torch.set_num_threads(2)

DTYPES = (torch.float32, torch.float64)
IDS = ("f32", "f64")
SPHERES, WIDTH, HEIGHT, DEPTH = 64, 64, 32, 3


def _inputs(dtype, glossy: bool):
    """train_deep's arguments on inverse_task_scene(SPHERES) at WIDTH x
    HEIGHT, depth 3: the target and (glossy) the xi stack seeded with numpy."""
    scene = inverse_task_scene(SPHERES, WIDTH, HEIGHT, dtype=dtype)
    cfg = RenderConfig(max_depth=DEPTH, dtype=dtype, visibility="smooth", use_pallas=True)
    o, d, tables, kw = bss._kernel_inputs(scene.camera.position, ray_directions_t(scene.camera, dtype), scene, cfg)
    rng = np.random.default_rng(11)
    tgt = torch.as_tensor(rng.uniform(0.0, 1.0, d.shape), dtype=dtype)
    xi = torch.as_tensor(rng.uniform(0.0, 1.0, (2 * DEPTH, d.shape[1])), dtype=dtype) if glossy else None
    return (o, d, tgt, *tables, xi), kw


@pytest.fixture(scope="module", params=[(dt, g) for dt in DTYPES for g in (False, True)],
                ids=[f"{i}-{'glossy' if g else 'mirror'}" for i in IDS for g in (False, True)])
def chain(request):
    """The plain train step without the skips, with each forward bounce's
    (o, d, f) and each Phase C call's terms and reach captured."""
    args, kw = _inputs(*request.param)
    bounces, phase_c = [], {"pairs": 0, "unreached": 0, "nonzero": 0}
    real_fwd, real_terms = bss.fwd_sub_math, bss.shadow_terms

    def fwd(o, d, *a, **k):
        out = real_fwd(o, d, *a, **k)
        if k.get("saved") is None:
            bounces.append((torch.stack(o, 1), torch.stack(d, 1), out))
        return out

    def terms(fs, k, c, r, fn, g_cc, faraway, active=None):
        out = real_terms(fs, k, c, r, fn, g_cc, faraway, active)
        lane = bss.phase_c_reach(fs, k, c, r, fn, faraway)
        _, disc, _, _, _ = fn(fs.p_n, fs.L, c, r, faraway)
        own = (fs.idx != k) & (bss.sig(fs.sharp_s * disc) != 0)
        phase_c["pairs"] += own.numel()
        phase_c["unreached"] += int((~lane).sum())
        for t in (x for group in out for x in group):
            phase_c["nonzero"] += int((t[~own] != 0).sum())
        return out

    bss.fwd_sub_math, bss.shadow_terms = fwd, terms
    try:
        full = bss.train_deep_plain(*args, **kw)
    finally:
        bss.fwd_sub_math, bss.shadow_terms = real_fwd, real_terms
    return args, kw, full, bounces, phase_c


def test_plain_with_the_skips_is_bitwise_without(chain):
    """train_deep_plain(skip=True): the winner sweeps, shadow products and
    Phase C over the pairs the kernel's skips keep, bitwise without."""
    args, kw, full, _, _ = chain
    got = bss.train_deep_plain(*args, **kw, skip=True)
    assert all(torch.equal(a, b) for a, b in zip(got, full))


def test_rejected_pairs_change_nothing_on_the_chain(chain):
    """On every forward bounce no winner pair the warp rules reject is a hit
    or has a disc above the lane's dmax before its chunk, no shadow pair the
    warp bound rejects has a nonzero sigmoid; no Phase C term of a pair
    that reaches no lane is nonzero; each rule rejects some pairs."""
    args, kw, _, bounces, phase_c = chain
    geom, consts, s_cheap, faraway = args[3], args[5], kw["s_cheap"], kw["faraway"]
    assert len(bounces) == DEPTH and s_cheap >= bss.STEP_SKIP_MIN_CHEAP
    rejected = {"winner": 0, "shadow": 0}
    for o, d, fs in bounces:
        n_rej, bad = _winner_misses(o, d, geom, s_cheap, faraway, bss.winner_reach(o, d, geom, s_cheap, faraway))
        assert bad == 0
        rejected["winner"] += n_rej
        n_rej, bad = _shadow_misses(torch.stack(fs.p_n, 1), torch.stack(fs.L, 1), consts[0, 3:6], geom[:s_cheap])
        assert bad == 0
        rejected["shadow"] += n_rej
    assert min(rejected.values()) > 0, rejected
    assert phase_c["nonzero"] == 0 and phase_c["unreached"] > 0, phase_c


def _nearest_equal(o, d, geom, s_cheap, faraway=1e30) -> int:
    """smooth_nearest_parts_plain with the skip bitwise without, on rays
    ``o``/``d`` (N, 3); returns the (warp, sphere) pairs the skip leaves out."""
    kw = dict(faraway=faraway, s_cheap=s_cheap)
    full, got = sp.smooth_nearest_parts_plain(o, d, geom, **kw), sp.smooth_nearest_parts_plain(o, d, geom, **kw,
                                                                                              skip=True)
    assert all(torch.equal(a, b) for a, b in zip(got, full))
    return int((~bss.winner_reach(o, d, geom, s_cheap, faraway)).sum())


def test_nearest_parts_skip_is_bitwise_on_the_chain(chain):
    """The shard sweep's skip on each bounce's rays over the scene's table
    with its last sphere in the exact tier (a shard's layout): bitwise the
    full sweep, and it leaves pairs out."""
    args, kw, _, bounces, _ = chain
    skipped = sum(_nearest_equal(o, d, args[3], args[3].shape[0] - 1, kw["faraway"]) for o, d, _ in bounces)
    assert skipped > 0


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_nearest_parts_skip_is_bitwise_on_edge_fans(dtype):
    """The fans at r_eff's edge from far origins and at the dmax edge: the
    full sweep bitwise, the dmax fans with pairs left out."""
    p_n, light_dir, _, geom = _fans(dtype)
    _nearest_equal(p_n, light_dir, geom, geom.shape[0])
    assert sum(_nearest_equal(o, d, geom, geom.shape[0]) for o, d, geom in _dmax_fans(dtype)) > 0


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_wrappers_take_skip_on_the_cpu(dtype):
    """On CPU tensors train_deep, nearest_parts and smooth_nearest_parts take
    every value of ``skip`` (the plain versions), the same bitwise; a bad
    value raises."""
    args, kw = _inputs(dtype, False)
    want = bss.train_deep(*args, **kw)
    for skip in f.SKIP:
        assert all(torch.equal(a, b) for a, b in zip(bss.train_deep(*args, **kw, skip=skip), want))
    with pytest.raises(ValueError, match="skip"):
        bss.train_deep(*args, **kw, skip="sometimes")
    o, d, geom = args[0].T.contiguous(), args[1].T.contiguous(), args[3]
    nkw = dict(faraway=kw["faraway"], s_cheap=kw["s_cheap"])
    full = sp.nearest_parts(o, d, geom, **nkw)
    for skip in f.SKIP:
        for fn in (sp.nearest_parts, sp.smooth_nearest_parts):
            assert all(torch.equal(a, b) for a, b in zip(fn(o, d, geom, **nkw, skip=skip), full))
    with pytest.raises(ValueError, match="skip"):
        sp.nearest_parts(o, d, geom, **nkw, skip="sometimes")


@pytest.mark.parametrize(("n", "s", "rows"), ((256 * 144, 1024, 288), (960 * 540, 3, 4050), (64 * 32, 64, 16)))
def test_row_layout_bytes(n, s, rows):
    """train_deep's table-gradient partials are smooth_bwd_step's rows (one a
    CTA of 4 ray-warps, 19 S + 16 values), beside smooth_bwd_deep's column
    partials ((23 S + 17) values a column, a column a ray-warp up to
    PARTIAL_COLS), which train_deep also took before: config 5's 22.4 MB in
    place of 108.6 MB."""
    assert bss.step_rows(n) == rows
    assert bss.step_rows_bytes(n, s, torch.float32) == rows * (19 * s + 16) * 4
    assert bss.partials_bytes(n, s, torch.float32) == (23 * s + 17) * min(-(-n // 32), bss.PARTIAL_COLS) * 4


def test_python_constants_mirror_the_source():
    """The SSE's column, train_deep's occupancy code and launch rule and the
    nearest sweep's launch rule are the CUDA source's; both rules take the
    skips from 16 cheap spheres, as smooth_fwd_step's and clear_fwd's."""
    step = (_build.CSRC / "bounce_smooth_sub.cu").read_text()
    assert "constexpr int kTrainSse = kAdjConsts;" in step
    assert int(re.search(r"constexpr int kAdjConsts = (\d+);", (_build.CSRC / "smooth_math.cuh").read_text())
               .group(1)) == bss.TRAIN_SSE_COL
    for term in ("case 6:  // train_deep with its skips", "skip < -1 || skip > 1",
                 "const bool on = skip < 0 ? s_cheap >= kStepSkipMinCheap : skip == 1;",
                 "reduce_rows<T><<<2 * s_total + 1, kReduceThreads, 0, st>>>(pg, pm, pc, flat"):
        assert term in step, term
    assert bss._SKIP_OCCUPANCY == {"smooth_fwd_step": 5, "train_deep": 6}
    parts = (_build.CSRC / "smooth_parts.cu").read_text()
    assert int(re.search(r"constexpr int kNearestSkipMinCheap = (\d+);", parts).group(1)) == sp.NEAREST_SKIP_MIN_CHEAP
    assert "skip < 0 ? s_cheap >= kNearestSkipMinCheap : skip == 1" in parts
    assert sp.NEAREST_SKIP_MIN_CHEAP == bss.STEP_SKIP_MIN_CHEAP == 16


def test_split_patches_apply_once_to_the_source():
    """Every variant of train_deep_split's row layout patches the shipped
    sources exactly once; the column layout's markers are not all there."""
    package = _build.CSRC.parent
    assert layout_of(package, train_deep_split.LAYOUTS) == "rows"
    layout = train_deep_split.LAYOUTS["rows"]
    for name, patches in layout["stubs"].items():
        for file, pattern, replacement in layout["common"] + patches:
            _, n = re.subn(pattern, replacement, (package / file).read_text(), flags=re.DOTALL)
            assert n == 1, name
    stubs = {name: set(lay["stubs"]) for name, lay in train_deep_split.LAYOUTS.items()}
    assert set(train_deep_split.STUBS) == stubs["rows"] == stubs["columns"] - {"regs"}
