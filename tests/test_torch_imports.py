"""The port imports neither jax, cv2, PIL, networkx nor the JAX package
panovlm_tpu (the machine with the card has no jax, no cv2 and no networkx,
and the port keeps its own copies of the host code it needs, its own PNG
and JPEG codecs among them); the same holds for chip_smoke.py. The port's
CLI runs each of the reference's five stage verbs (the five pair-surgery
verbs: tests/test_torch_pair_surgery.py)."""

import os
import subprocess
import sys

import pytest
import torch

from panovlm_tpu import pipeline as jax_pipeline
from panovlm_tpu_torch import pipeline
from panovlm_tpu_torch.__main__ import STAGES, main

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = r"""
import importlib
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "cv2", "PIL", "networkx", "panovlm_tpu")   # top-level names, exact

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
import panovlm_tpu_torch
mods = ["panovlm_tpu_torch.__main__"] + [
    m.name for m in pkgutil.walk_packages(panovlm_tpu_torch.__path__, "panovlm_tpu_torch.")]
for m in mods + ["chip_smoke"]:
    importlib.import_module(m)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
assert len(mods) > 30, mods
for m in ("native.lsd", "utils.panorama_line", "models.camera_lidar", "io.jpeg",
          "native.jpeg", "models.texture", "ops.lbd", "native.lk", "models.line_tracks",
          "pair_surgery", "utils.gps", "parallel.sharding", "parallel.halo",
          "parallel.multihost", "native.bmp", "native.pxm", "native.sunras", "native.tiff",
          "native.gif"):
    assert "panovlm_tpu_torch." + m in mods, m
print("ok")
"""


def test_port_imports_without_jax_or_cv2():
    """Also without networkx (the SfM graph filters use utils/graph.py)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("stage", sorted(jax_pipeline.STAGES))
def test_cli_runs_every_reference_verb(stage, tmp_path, monkeypatch):
    """Each verb of `python -m panovlm_tpu` reaches its stage function in
    the port (stubbed here), with the config and the device asked for."""
    assert set(STAGES) == set(jax_pipeline.STAGES)
    calls = []
    monkeypatch.setattr(pipeline, stage,
                        lambda cfg, tr, device, **kw: calls.append((cfg.result_path, device)))
    cfg = tmp_path / "config.txt"
    cfg.write_text(f"result_path = {tmp_path}/result\n")
    assert main([stage, str(cfg), "--device", "cpu"]) == 0
    assert calls == [(f"{tmp_path}/result", torch.device("cpu"))]


def test_native_libraries_build_from_the_checkout():
    """The scan reader, the LSD, the JPEG decoder, the LK flow, the SIFT
    detector and the BMP, PxM / PAM / PFM, Sun raster, TIFF and GIF decoders
    compile with g++ into build/native/ at first use (the TIFF decoder
    built together with the JPEG decoder and linked with zlib; the scan reader has a numpy fallback, the others
    none)."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    from panovlm_tpu_torch import native
    from panovlm_tpu_torch.native import jpeg, lk, lsd, sift
    assert native.build() is not None
    for mod, name in ((lsd, "lsd.cpp"), (jpeg, "jpeg.cpp"), (lk, "lk.cpp"), (sift, "sift.cpp")):
        assert mod.get() is not None and mod._SRC.name == name
        flags = mod.build_flags() if hasattr(mod, "build_flags") else ()
        assert native.library_path(mod._SRC, flags).exists()
    from panovlm_tpu_torch.native import bmp, gif, pxm, sunras, tiff
    for mod, name in ((bmp, "bmp.cpp"), (pxm, "pxm.cpp"), (sunras, "sunras.cpp"),
                      (tiff, "tiff.cpp"), (gif, "gif.cpp")):
        assert mod._DECODER.get() is not None and mod._SRC.name == name
        assert native.library_path(mod._SRC, libs=mod._DECODER.libs,
                                   extra=mod._DECODER.extra).exists()


def test_cuda_device_is_never_replaced_by_the_cpu():
    from panovlm_tpu_torch.device import resolve
    assert resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve("cuda")
