"""``python -m python_ray_tracer_tpu_torch``: render the reference scene.

With no arguments it renders the 3-sphere reference scene at 960x540 on
the default device (CUDA) to ``render_out.png``; any arguments go to the
CLI (see :mod:`.cli`).
"""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["render", "--builtin", "reference", "-o", "render_out.png"]))
