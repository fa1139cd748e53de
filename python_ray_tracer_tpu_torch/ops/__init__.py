"""Tensor ops and the CUDA bounce kernels' wrappers."""

import importlib

# The modules that hold a kernel wrapper: each counts its launches in
# LAUNCHES, and one with an atlas mode counts those in ATLAS_LAUNCHES (the
# shadow sweep's parts mode in PARTS_LAUNCHES).
KERNEL_MODULES = (
    "bounce_sub", "bounce_smooth_sub", "culled", "culled_smooth", "intersect_fused", "bounce_lane", "smooth_parts",
)


def _counters() -> list[tuple[dict[str, int], str]]:
    out = []
    for name in KERNEL_MODULES:
        module = importlib.import_module(f"{__name__}.{name}")
        out.append((module.LAUNCHES, "{}"))
        if hasattr(module, "ATLAS_LAUNCHES"):
            out.append((module.ATLAS_LAUNCHES, "{} (atlas)"))
        if hasattr(module, "PARTS_LAUNCHES"):
            out.append((module.PARTS_LAUNCHES, "{}"))
    return out


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launches in this process (an atlas mode's under
    ``"<kernel> (atlas)"``)."""
    return {fmt.format(k): v for counts, fmt in _counters() for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts, _ in _counters():
        for k in counts:
            counts[k] = 0
