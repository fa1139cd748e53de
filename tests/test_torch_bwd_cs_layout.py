"""``bwd_cs``'s launch layout (``ops/culled_smooth.py``, ``csrc/culled_smooth.cu``)
and the split script that times it (``benchmarks/bwd_cs_split.py``).

A tile's rays (``CULL_BLOCK_RAYS``, one candidate list) are shared by
``BWD_CTAS_PER_TILE`` CTAs, each with one row of table gradients: the
launch arithmetic at config 4 (1920x1080) and at the atlas loss's 960x540,
the row bytes against the one-CTA-per-tile layout's (8 warp rows a tile),
the refusals, and the Python constants against the CUDA source's.  No JAX,
no kernel: the kernel runs on the card (``chip_smoke.py``).
"""

import re

import pytest

torch = pytest.importorskip("torch")

from python_ray_tracer_tpu_torch.benchmarks import bwd_cs_split  # noqa: E402
from python_ray_tracer_tpu_torch.ops import _build  # noqa: E402
from python_ray_tracer_tpu_torch.ops import culled_smooth as cs  # noqa: E402
from python_ray_tracer_tpu_torch.ops.culled import CULL_BLOCK_RAYS  # noqa: E402

SMS = 132  # an H100 SXM's streaming multiprocessors
SPHERES = 1024
ROW_VALUES = 19 * SPHERES + 16  # (S, 4) + (S, 15) + 16 a row


def _padded(width: int, height: int) -> int:
    return -(-(width * height) // CULL_BLOCK_RAYS) * CULL_BLOCK_RAYS


@pytest.mark.parametrize("width,height,tiles", [(1920, 1080, 507), (960, 540, 127)])
def test_launch_arithmetic(width, height, tiles):
    """8 CTAs a 4096-ray tile, one row each: as many rows as the one-CTA
    layout's 8 warp rows a tile, so no more table-gradient bytes (315.9 MB
    f32 at config 4), and more CTAs than the card has SMs."""
    n = _padded(width, height)
    assert n // CULL_BLOCK_RAYS == tiles
    rows = cs.bwd_rows(n, CULL_BLOCK_RAYS)
    assert rows == tiles * cs.BWD_CTAS_PER_TILE == tiles * 8
    assert rows > SMS
    assert CULL_BLOCK_RAYS // (cs.BWD_CTAS_PER_TILE * cs.BWD_THREADS) == cs.BWD_BATCH  # one round a thread
    one_cta_layout = tiles * 8 * ROW_VALUES * 4
    assert cs.grad_rows_bytes(n, SPHERES, CULL_BLOCK_RAYS, torch.float32) == rows * ROW_VALUES * 4 <= one_cta_layout
    if width == 1920:
        assert one_cta_layout == 315_913_728


@pytest.mark.parametrize("tile_rays", [256, 1000, 1536, 4096 + 512, 0])
def test_bwd_rows_refuses_a_tile_the_cta_split_does_not_divide(tile_rays):
    """A tile must split into BWD_CTAS_PER_TILE CTAs of BWD_THREADS threads
    (the one-CTA layout took any multiple of 256)."""
    with pytest.raises(ValueError, match="multiple of 1024"):
        cs.bwd_rows(8 * 4096, tile_rays)


def test_bwd_rows_refuses_a_ragged_frame():
    with pytest.raises(ValueError, match="whole tiles"):
        cs.bwd_rows(4096 * 3 + 1024, 4096)


def test_shared_bytes_fit_the_largest_culled_table():
    """The culled smooth route takes at most MAX_BLK_SPHERES_SMOOTH spheres;
    bwd_cs's CTA fits them in f64, the round's state and scratch included."""
    s = cs.MAX_BLK_SPHERES_SMOOTH
    assert cs.bwd_shared_bytes(s, torch.float64) <= _build.MAX_SHARED_BYTES
    assert cs.bwd_shared_bytes(SPHERES, torch.float32) == (4 * SPHERES + 16 + 10 * 4 * 128 + 1920) * 4 + 4 * 4 * 128


def test_python_constants_mirror_the_source():
    text = (_build.CSRC / "culled_smooth.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert (const("kBwdThreads"), const("kBwdCtasPerTile"), const("kBwdBatch")) == (
        cs.BWD_THREADS, cs.BWD_CTAS_PER_TILE, cs.BWD_BATCH)


def test_split_patches_apply_once_to_the_source():
    """Every variant of the split script patches the shipped source exactly
    once (a stale pattern would fail on the card, after the builds)."""
    text = (_build.CSRC / "culled_smooth.cu").read_text()
    layout = bwd_cs_split.LAYOUTS[bwd_cs_split.layout_of(_build.CSRC.parent)]
    assert layout is bwd_cs_split.LAYOUTS["cta_split"]
    for name, patches in layout["stubs"].items():
        for file, pattern, replacement in layout["common"] + patches:
            assert file == bwd_cs_split.SOURCE
            _, n = re.subn(pattern, replacement, text, flags=re.DOTALL)
            assert n == 1, name


def test_ptxas_report_reads_each_instantiation():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16bwd_csIfLb1ELb0EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_16bwd_csIfLb1ELb0EEEvPKT_",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 440 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19reduce_csIdEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16bwd_csIdLb0ELb1EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 255 registers",
    ])
    assert bwd_cs_split.ptxas_report(log) == {
        "f32 glossy": {"spill_stores": 8, "spill_loads": 12, "registers": 168},
        "f64 atlas": {"registers": 255},
    }
