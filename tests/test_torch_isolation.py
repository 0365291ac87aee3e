"""The port imports neither jax nor the JAX package.

Every module of ``audio_processor_tpu_torch`` is imported in a fresh
interpreter with both names blocked on ``sys.meta_path``; ``chip_smoke.py``
is checked by its AST, since running it needs a card.
"""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "audio_processor_tpu")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_every_port_module_imports_without_jax():
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import audio_processor_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        # the word-timestamp, int8, conversion, training and mesh-service
        # modules are among them
        for name in ("models.whisper.align", "models.whisper.quantize", "ops.kernels.dtw",
                     "models.whisper.convert", "models.diarization.convert",
                     "training.pytree_io", "training.train_step", "training.checkpoint",
                     "training.diarization_trainer", "training.embedding_trainer",
                     "parallel.controller", "parallel.mesh", "parallel.multihost",
                     "runtime.services", "serve", "native.build", "native.audio_io",
                     "native.media", "pipeline.ingest"):
            assert pkg.__name__ + "." + name in names, name
        leaked = [m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 20  # every subpackage was walked


def _imported_names(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


@pytest.mark.parametrize("rel", ["chip_smoke.py"])
def test_script_imports_no_jax(rel):
    names = list(_imported_names(os.path.join(REPO, rel)))
    assert "torch" in names
    assert not [n for n in names if _blocked(n)], names


def test_port_sources_name_no_jax_import():
    """Belt and braces over the subprocess check: no port source has an
    import statement for a blocked module, even on a branch not taken."""
    root = os.path.join(REPO, "audio_processor_tpu_torch")
    bad = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                bad += [(p, n) for n in _imported_names(p) if _blocked(n)]
    assert not bad, bad


def test_port_names_no_path_into_the_jax_package_native_module():
    """The port builds its own copies of the C++ sources: no file of it
    (Python, C++, CUDA) names the JAX package's ``native`` directory."""
    root = os.path.join(REPO, "audio_processor_tpu_torch")
    bad = []
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for f in files:
            if f.endswith((".py", ".cc", ".cu", ".cuh")):
                p = os.path.join(dirpath, f)
                if "audio_processor_tpu/native" in open(p, encoding="utf-8").read():
                    bad.append(p)
    assert not bad, bad


def test_port_builds_only_its_own_sources():
    from audio_processor_tpu_torch.native import build as native_build
    from audio_processor_tpu_torch.ops.kernels import build as kernel_build

    port = os.path.join(REPO, "audio_processor_tpu_torch")
    assert str(native_build.SRC) == os.path.join(port, "native")
    assert str(kernel_build.CSRC) == os.path.join(port, "csrc")
    assert native_build.BUILD_DIR == kernel_build.BUILD_DIR
    assert sorted(p.name for p in native_build.SRC.glob("*.cc")) == ["audio_io.cc",
                                                                      "media_decode.cc"]
    for name in ("audio_io", "media_decode"):
        assert native_build.library_path(name).parent == native_build.BUILD_DIR
