"""Run a gallery script and keep every frame it renders.

    python tests/torch_example_capture.py PACKAGE OUT.npz SCRIPT [ARGS...]

PACKAGE is ``nerf_rs_tpu`` or ``nerf_rs_tpu_torch``. Its
``render.render_image`` is wrapped so that each frame it returns is kept;
SCRIPT then runs as ``__main__`` with ARGS, unchanged, and the frames are
written to OUT.npz as ``frame_0``, ``frame_1``, ... in the order the script
rendered them. ``tests/test_torch_examples.py`` uses it to hold a port
script's frames to those of its JAX counterpart, which writes no image.
"""

import importlib
import runpy
import sys
from pathlib import Path

import numpy as np


def main() -> None:
    package, out, script, *args = sys.argv[1:]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    render = importlib.import_module(f"{package}.render")
    real = render.render_image
    frames = []

    def keep(*a, **kw):
        img = real(*a, **kw)
        frames.append(np.asarray(img.detach().cpu() if hasattr(img, "detach") else img))
        return img

    render.render_image = keep
    sys.argv = [script, *args]
    runpy.run_path(script, run_name="__main__")
    np.savez(out, **{f"frame_{i}": f for i, f in enumerate(frames)})


if __name__ == "__main__":
    main()
