"""Self-contained release bundle of the PyTorch port (counterpart of
qwen3_asr_gguf_tpu/cli/release.py): a relocatable zip carrying what a
deployment needs beyond a Python with PyTorch (and, for the kernels, the
CUDA toolkit's nvcc):

  qwen3_asr_gguf_tpu_torch/  package source with csrc/*.cu and *.cuh (the
                             kernels build at first use, into the package's
                             build/ inside the extracted tree)
  native/                    host codec sources (+ the built library when there is one)
  bin/transcribe, bin/serve  launcher shims (also bin/quant-accuracy, bin/export)
  README.md, RELEASE.json    docs; name / version / git revision / build stamp

Nothing of the JAX package is bundled: not its source, not the repo-root
examples (the port's are `qwen3_asr_gguf_tpu_torch/examples/`), not the
packaging file that names it, and `start_server.sh` only when it launches
the port.

Usage:
  python -m qwen3_asr_gguf_tpu_torch.cli.release --out dist/
  unzip qwen3-asr-gguf-tpu-torch-<ver>.zip && cd qwen3-asr-gguf-tpu-torch-<ver>
  ./bin/transcribe audio.wav --model-dir model/
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
import zipfile
from pathlib import Path

_PKG_ROOT = Path(__file__).resolve().parent.parent  # qwen3_asr_gguf_tpu_torch/
_REPO = _PKG_ROOT.parent
NAME = "qwen3-asr-gguf-tpu-torch"

_LAUNCHER = """#!/bin/sh
# launcher shim: run the bundled package with the host python and torch
HERE="$(cd "$(dirname "$0")/.." && pwd)"
PYTHONPATH="$HERE${{PYTHONPATH:+:$PYTHONPATH}}" exec {python} -m {module} "$@"
"""
SHIMS = (
    ("transcribe", "qwen3_asr_gguf_tpu_torch.cli.transcribe"),
    ("serve", "qwen3_asr_gguf_tpu_torch.cli.serve"),
    ("quant-accuracy", "qwen3_asr_gguf_tpu_torch.cli.quant_accuracy"),
    ("export", "qwen3_asr_gguf_tpu_torch.export"),
)


def _git_rev() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=str(_REPO),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def _copy_pkg(dst: Path) -> None:
    shutil.copytree(
        _PKG_ROOT, dst / _PKG_ROOT.name,
        ignore=shutil.ignore_patterns("__pycache__", "*.pyc", ".*", "build"),
    )


def build_release(out_dir: Path, *, with_native: bool = True) -> Path:
    """Assemble the release tree and zip it; returns the zip path."""
    from .. import __version__ as ver

    name = f"{NAME}-{ver}"
    stage = out_dir / name
    if stage.exists():
        shutil.rmtree(stage)
    stage.mkdir(parents=True)

    _copy_pkg(stage)

    # native host codecs: the sources so another host can rebuild them in
    # place (`python -m qwen3_asr_gguf_tpu_torch.native build`), and the
    # built library at the path native.load() searches
    native_src = _REPO / "native"
    if native_src.is_dir():
        shutil.copytree(
            native_src / "src", stage / "native" / "src",
            ignore=shutil.ignore_patterns("__pycache__"),
        )
        shutil.copy2(native_src / "CMakeLists.txt", stage / "native" / "CMakeLists.txt")
        if with_native:
            from .. import native as native_mod

            if not native_mod.available():
                try:
                    native_mod.build(verbose=False)
                except Exception as e:  # a source-only bundle still works
                    print(f"native build skipped ({e!r}); bundling sources only",
                          file=sys.stderr)
            for so in (native_src / "build" / "libqwen3asr_host.so",
                       native_src / "libqwen3asr_host.so"):
                if so.exists():
                    shutil.copy2(so, stage / "native" / so.name)
                    break

    bindir = stage / "bin"
    bindir.mkdir()
    for shim, module in SHIMS:
        p = bindir / shim
        p.write_text(_LAUNCHER.format(python="python3", module=module))
        p.chmod(0o755)

    shutil.copy2(_REPO / "README.md", stage / "README.md")
    launcher = _REPO / "start_server.sh"
    if launcher.exists() and _PKG_ROOT.name in launcher.read_text():
        shutil.copy2(launcher, stage / launcher.name)

    (stage / "RELEASE.json").write_text(json.dumps({
        "name": NAME,
        "version": ver,
        "git_rev": _git_rev(),
        "built": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "python": f"{sys.version_info.major}.{sys.version_info.minor}",
        "native_bundled": any((stage / "native").glob("*.so")),
    }, indent=2) + "\n")

    zip_path = out_dir / f"{name}.zip"
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for p in sorted(stage.rglob("*")):
            if p.is_file():
                zf.write(p, p.relative_to(out_dir))
    return zip_path


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="dist", help="output directory")
    ap.add_argument("--no-native", action="store_true",
                    help="skip building/bundling the native codec library")
    args = ap.parse_args(argv)
    zip_path = build_release(Path(args.out), with_native=not args.no_native)
    print(zip_path)


if __name__ == "__main__":
    main()
