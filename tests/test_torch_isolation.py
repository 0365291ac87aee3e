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
                     "native.media", "pipeline.ingest", "tools.make_bundled_diarizer",
                     "tools.verify_parity", "tools.make_parity_case"):
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


def _constants_outside_docstrings(tree):
    """Every string constant of a module's AST that is not a docstring
    (the first statement of a module, class or function body)."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node


def _jax_package_paths(source):
    return [(node.lineno, node.value)
            for node in _constants_outside_docstrings(ast.parse(source))
            if node.value == "audio_processor_tpu" or "audio_processor_tpu/" in node.value]


def test_port_names_no_path_into_the_jax_package():
    """No port module builds a path into the JAX package: no string
    constant other than a docstring (which cites ``file:line`` as prose)
    equals the package's name or contains ``audio_processor_tpu/``."""
    root = os.path.join(REPO, "audio_processor_tpu_torch")
    bad = []
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                bad += [(p, line, v) for line, v in
                        _jax_package_paths(open(p, encoding="utf-8").read())]
    assert not bad, bad


@pytest.mark.parametrize("source, found", [
    ('X = os.path.join(ROOT, "audio_processor_tpu", "webui")\n', [(1, "audio_processor_tpu")]),
    ('def f():\n    return "audio_processor_tpu/assets"\n', [(2, "audio_processor_tpu/assets")]),
    ('"""Cites audio_processor_tpu/ops/frontend.py:243."""\n', []),
    ('def f():\n    """See audio_processor_tpu/x.py:1."""\n', []),
    ('X = "audio_processor_tpu_torch"\n', []),
])
def test_jax_package_path_check_sees_constants_not_docstrings(source, found):
    assert _jax_package_paths(source) == found


def _files_under(root):
    out = set()
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out |= {os.path.relpath(os.path.join(dirpath, f), root) for f in files}
    return out


@pytest.mark.parametrize("sub", ["webui", "assets"])
def test_port_data_is_a_byte_equal_copy_of_the_jax_package_data(sub):
    """The web UI and the bundled diarizer are data the port carries
    itself: the same files as the JAX package's, byte for byte."""
    port = os.path.join(REPO, "audio_processor_tpu_torch", sub)
    jax_side = os.path.join(REPO, "audio_processor_tpu", sub)
    names = _files_under(port)
    assert names == _files_under(jax_side)
    assert names  # the copy is there
    for rel in sorted(names):
        with open(os.path.join(port, rel), "rb") as a, open(os.path.join(jax_side, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_port_loads_its_own_bundled_diarizer(monkeypatch):
    from audio_processor_tpu_torch.models.diarization import checkpoint as ckpt
    from audio_processor_tpu_torch.pipeline import diarize

    port = os.path.join(REPO, "audio_processor_tpu_torch")
    assert diarize.ASSETS_DIR == os.path.join(port, "assets")
    read, real = [], ckpt._read
    monkeypatch.setattr(ckpt, "_read", lambda path: read.append(os.path.abspath(path)) or real(path))
    d = diarize.Diarizer.bundled(device="cpu")
    assert d is not None and d.provenance == "bundled-synthetic"
    assert set(read) == {os.path.join(port, "assets", "diarizer_emb.npz"),
                         os.path.join(port, "assets", "diarizer_seg.npz")}


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


# JAX names with no counterpart by design (ROADMAP.md lists them): the
# Pallas interpret switch, the functional nets' Params (the trainer's alias
# too) and forward (the port has nn.Modules), JAX sharding specs,
# model.attention (the port's masked_attention), a module logger, and the
# Pallas mel kernel's own names (its port is kernel A, ops/kernels/log_mel.py's
# log_mel)
BY_DESIGN = {
    "ops/pallas/decode_attention.py": {"interpret_requested"},
    "ops/pallas/mel_kernel.py": {"log_mel_pallas", "FRAME_TILE", "HOP"},
    "models/diarization/segmentation_tpu.py": {"Params", "forward"},
    "models/diarization/segmentation.py": {"Params", "forward"},
    "models/diarization/embedding.py": {"Params", "forward"},
    "training/diarization_trainer.py": {"Params"},
    "parallel/sharding.py": {"param_shardings"},
    "parallel/mesh.py": {"data_sharding", "replicated"},
    "models/whisper/model.py": {"attention"},
    "training/checkpoint.py": {"logger"},
}
# the one module whose port has another name (besides ops/pallas -> ops/kernels)
RENAMED = {"ops/pallas/mel_kernel.py": "ops/kernels/log_mel.py"}
# names the port keeps in another module than JAX does
MOVED = {"models/diarization/checkpoint.py": {
    "load_cluster_threshold", "DECODE_META_KEYS", "load_decode_meta", "load_onset",
    "synth_voice", "flatten_tree", "unflatten_tree", "load_diarizer_params"},
    "ops/frontend.py": {"N_FREQS"}}


def _public_names(path):
    """Top-level functions, classes and assigned names not led by ``_``."""
    names = set()
    for node in ast.parse(open(path, encoding="utf-8").read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    root = os.path.join(REPO, "audio_processor_tpu")
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "webui", "assets"))
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), root).replace(os.sep, "/")


@pytest.mark.parametrize("rel", list(_jax_modules()))
def test_every_jax_public_name_has_a_port_counterpart(rel):
    """By the AST, importing nothing: each public name of a JAX module is
    in the port's module of the same path, in the module ``MOVED`` names,
    or listed in ``BY_DESIGN``."""
    port_rel = RENAMED.get(rel, rel.replace("ops/pallas/", "ops/kernels/"))
    port = os.path.join(REPO, "audio_processor_tpu_torch", port_rel)
    assert os.path.exists(port), port_rel
    moved = {}
    for mod, names in MOVED.items():
        found = _public_names(os.path.join(REPO, "audio_processor_tpu_torch", mod))
        moved.update({n: mod for n in names & found})
    missing = _public_names(os.path.join(REPO, "audio_processor_tpu", rel)) - _public_names(port)
    assert not missing - BY_DESIGN.get(rel, set()) - set(moved), sorted(missing)


# the JAX repository's tools and their ports; the JAX verify_parity's REPO
# is the directory it runs pytest in, where the port calls its gates in-process
TOOLS = ("make_bundled_diarizer.py", "verify_parity.py", "make_parity_case.py")
TOOLS_BY_DESIGN = {"verify_parity.py": {"REPO"}}


@pytest.mark.parametrize("name", TOOLS)
def test_every_jax_tool_public_name_has_a_port_counterpart(name):
    """By the AST: each public name of the JAX tool ``tools/<name>`` is in
    the port's ``tools/<name>``."""
    port = os.path.join(REPO, "audio_processor_tpu_torch", "tools", name)
    missing = _public_names(os.path.join(REPO, "tools", name)) - _public_names(port)
    assert not missing - TOOLS_BY_DESIGN.get(name, set()), sorted(missing)


@pytest.mark.parametrize("name", TOOLS)
def test_port_tools_name_no_path_into_the_jax_package(name):
    """No port tool reaches into the JAX package, its bundled assets
    included, by a string constant or in its prose; the builder's
    defaults read the port's own assets."""
    with open(os.path.join(REPO, "audio_processor_tpu_torch", "tools", name), encoding="utf-8") as f:
        source = f.read()
    assert _jax_package_paths(source) == []
    assert "audio_processor_tpu/" not in source and "audio_processor_tpu\"" not in source
    if name == "make_bundled_diarizer.py":
        from audio_processor_tpu_torch.pipeline.diarize import ASSETS_DIR
        from audio_processor_tpu_torch.tools import make_bundled_diarizer as tool

        assert tool.ASSETS_DIR == ASSETS_DIR == os.path.join(REPO, "audio_processor_tpu_torch",
                                                             "assets")
