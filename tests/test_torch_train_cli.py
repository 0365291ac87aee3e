"""The port's conversion-and-training subcommands against the JAX
package's, end to end on the CPU at tiny configs.

Both CLIs run on the same inputs and the same starting weights (a ``.npz``
JAX wrote; for the diarization trainers, which draw their own random
weights, the port starts from JAX's draw and both build tiny configs),
and print the same lines.  Printed losses carry 4 decimals, so each is
held to JAX's within 1e-4 relative plus 1e-4 (two roundings); the bf16
embedding trainer within 2e-2 relative.  ``calibrate-alignment-heads``
runs in float32 on both sides and must print the same heads and rewrite
the checkpoint to the same bytes, vocab included.  ``convert-whisper`` and
``convert-diarizer`` are in ``tests/test_torch_convert.py``.
"""
import functools
import json
import re

import numpy as np
import pytest
import torch

import jax

from audio_processor_tpu import cli as jcli
from audio_processor_tpu.models.diarization import embedding as jemb
from audio_processor_tpu.models.diarization import segmentation_tpu as jseg
from audio_processor_tpu.models.whisper import convert as jconvert
from audio_processor_tpu.models.whisper import model as jmodel
from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig
from audio_processor_tpu.models.whisper.tokenizer import BPETokenizer as JBPE
from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber
from audio_processor_tpu.training import diarization_trainer as jdt
from audio_processor_tpu.training import embedding_trainer as jet
from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.models.diarization import embedding as pemb
from audio_processor_tpu_torch.models.diarization import segmentation_tpu as pseg
from audio_processor_tpu_torch.models.whisper import convert
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from audio_processor_tpu_torch.training import diarization_trainer as pdt
from audio_processor_tpu_torch.training import embedding_trainer as pet
from audio_processor_tpu_torch.training import train_step as pts
from audio_processor_tpu_torch.utils import wavio
from test_torch_convert import _tokenizer, assert_npz_equal

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=512, n_text_ctx=32, n_text_state=64, n_text_head=2, n_text_layer=2)
LOSS = re.compile(r"loss (-?\d+\.\d+)")


def _losses(text: str) -> list[float]:
    return [float(x) for x in LOSS.findall(text)]


def assert_printed_losses_close(ours: str, ref: str, rel: float = 1e-4):
    a, b = _losses(ours), _losses(ref)
    assert a and len(a) == len(b), (ours, ref)
    for x, y in zip(a, b):
        assert abs(x - y) <= rel * abs(y) + 1e-4, (ours, ref)
    # everything but the numbers is the same text
    assert LOSS.sub("loss #", ours) == LOSS.sub("loss #", ref)


@pytest.fixture
def checkpoint(tmp_path):
    """A tiny-config .npz written by JAX, with an embedded vocab, and a
    manifest of three short WAVs."""
    jp = jmodel.init_params(JConfig(name="t", **DIMS), jax.random.PRNGKey(0))
    path = str(tmp_path / "ckpt.npz")
    jtok = JBPE.from_tiktoken_bytes(_tokenizer().to_tiktoken_bytes())
    jconvert.save_params(path, jp, JConfig(name="t", **DIMS), tokenizer=jtok)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        n = 16_000 * (1 + i % 2) // 2 + 1_000
        t = np.arange(n) / 16_000
        audio = (0.2 * np.sin(2 * np.pi * (180 + 60 * i) * t) + rng.normal(0, 0.01, n))
        wav = str(tmp_path / f"a{i}.wav")
        wavio.write_wav(wav, audio.astype(np.float32), 16_000)
        lines.append(json.dumps({"audio": wav, "text": f"hello there {i}"}))
    manifest = tmp_path / "m.jsonl"
    manifest.write_text("\n".join(lines) + "\n")
    return path, str(manifest)


def test_finetune_whisper_prints_jax_losses_and_saves(checkpoint, tmp_path, capsys):
    path, manifest = checkpoint
    args = [manifest, "--model-path", path, "--steps", "4", "--batch", "2", "--max-tokens", "12",
            "--lr", "1e-3", "--seed", "3"]
    ours, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    jcli.main(["finetune-whisper", *args, "--out", ref])
    jout = capsys.readouterr()
    cli.main(["finetune-whisper", *args, "--out", ours, "--device", "cpu"])
    out = capsys.readouterr()
    assert_printed_losses_close(out.err, jout.err)
    assert_printed_losses_close(out.out.replace(ours, "OUT"), jout.out.replace(ref, "OUT"))
    # the saved checkpoints: same members; weights within the 5-step bar
    with np.load(ours) as za, np.load(ref) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape
            if k.startswith("__"):
                assert za[k].tobytes() == zb[k].tobytes()
            else:
                np.testing.assert_allclose(za[k], zb[k], atol=1e-5)
    assert convert.load_tokenizer(ours).encode("hello") == _tokenizer().encode("hello")


def test_finetune_whisper_refusals_match_jax(checkpoint, tmp_path):
    path, manifest = checkpoint
    bare = str(tmp_path / "bare.npz")
    jconvert.save_params(bare, jmodel.init_params(JConfig(name="t", **DIMS), jax.random.PRNGKey(1)),
                         JConfig(name="t", **DIMS))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    for argv in ([manifest, "--model-path", bare], [str(empty)],
                 [manifest, "--model-path", path, "--max-tokens", "2"]):
        with pytest.raises(SystemExit) as ref:
            jcli.main(["finetune-whisper", *argv])
        with pytest.raises(SystemExit) as ours:
            cli.main(["finetune-whisper", *argv, "--device", "cpu"])
        assert str(ours.value.code) == str(ref.value.code)


SEG = dict(d_model=32, n_head=2, n_layer=2)
EMB = dict(base_channels=8, blocks=(1, 1, 1, 1), embed_dim=16)


def test_train_segmentation_prints_jax_losses(monkeypatch, tmp_path, capsys):
    """Both CLIs at a tiny net width; the port starts from JAX's draw."""
    monkeypatch.setattr(jseg, "TpuSegmentationConfig",
                        functools.partial(jseg.TpuSegmentationConfig, **SEG))
    monkeypatch.setattr(pseg, "TpuSegmentationConfig",
                        functools.partial(pseg.TpuSegmentationConfig, **SEG))

    def from_jax(cfg, generator, lr):
        jstate = jdt.init_train_state(jseg.TpuSegmentationConfig(window_s=cfg.window_s),
                                      jax.random.PRNGKey(int(generator.initial_seed())), lr=lr)
        net = pseg.params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
        return pdt.SegTrainState(net, pdt.make_optimizer(lr).init(pts.tree_leaves(net)), 0)

    monkeypatch.setattr(pdt, "init_train_state", from_jax)
    args = ["--steps", "3", "--batch", "2", "--window-s", "1.0", "--seed", "2"]
    ours, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    jcli.main(["train-segmentation", *args, "--out", ref])
    jout = capsys.readouterr().out
    cli.main(["train-segmentation", *args, "--out", ours, "--device", "cpu"])
    out = capsys.readouterr().out
    assert_printed_losses_close(out.replace(ours, "OUT"), jout.replace(ref, "OUT"))
    net, cfg = pdt.load_params(ours)
    assert cfg == pseg.TpuSegmentationConfig(window_s=1.0)


def test_train_embedding_prints_jax_losses(monkeypatch, tmp_path, capsys):
    """bf16 convs on both sides: the losses within 2e-2 relative."""
    monkeypatch.setattr(jemb, "EmbeddingConfig", functools.partial(jemb.EmbeddingConfig, **EMB))
    monkeypatch.setattr(pemb, "EmbeddingConfig", functools.partial(pemb.EmbeddingConfig, **EMB))

    def from_jax(cfg, n_speakers, generator, lr):
        jstate = jet.init_train_state(jemb.EmbeddingConfig(crop_s=cfg.crop_s), n_speakers,
                                      jax.random.PRNGKey(int(generator.initial_seed())), lr=lr)
        net = pemb.params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
        head = torch.from_numpy(np.array(jstate.head_w))
        return pet.EmbTrainState(net, head, pet.make_optimizer(lr).init(pts.tree_leaves((net, head))), 0)

    monkeypatch.setattr(pet, "init_train_state", from_jax)
    args = ["--steps", "3", "--batch", "4", "--speakers", "3", "--crop-s", "0.5", "--seed", "1"]
    ours, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    jcli.main(["train-embedding", *args, "--out", ref])
    jout = capsys.readouterr().out
    cli.main(["train-embedding", *args, "--out", ours, "--device", "cpu"])
    out = capsys.readouterr().out
    assert_printed_losses_close(out.replace(ours, "OUT"), jout.replace(ref, "OUT"), rel=2e-2)
    with np.load(ours) as za, np.load(ref) as zb:
        assert sorted(za.files) == sorted(zb.files)


def test_calibrate_alignment_heads_equals_jax(monkeypatch, tmp_path, capsys, speech_like_audio):
    """On a checkpoint of the "test" preset's widths (30 s windows)."""
    dims = dict(DIMS, n_audio_ctx=1500, n_text_ctx=448)
    path = str(tmp_path / "ckpt.npz")
    jtok = JBPE.from_tiktoken_bytes(_tokenizer().to_tiktoken_bytes())
    jconvert.save_params(path, jmodel.init_params(JConfig(name="t", **dims), jax.random.PRNGKey(4)),
                         JConfig(name="t", **dims), tokenizer=jtok)
    wav = str(tmp_path / "speech.wav")
    wavio.write_wav(wav, speech_like_audio, 16_000)
    for cls in (JTranscriber, Transcriber):
        monkeypatch.setattr(cls, "from_npz", classmethod(functools.partial(
            cls.from_npz.__func__, compute_dtype="float32", max_new_tokens=16)))
    ours = str(tmp_path / "port.npz")
    with open(path, "rb") as f, open(ours, "wb") as g:
        g.write(f.read())
    jcli.main(["calibrate-alignment-heads", path, wav, "--top-k", "3", "--write"])
    jout = capsys.readouterr()
    cli.main(["calibrate-alignment-heads", ours, wav, "--top-k", "3", "--write",
              "--device", "cpu"])
    out = capsys.readouterr()
    assert out.out == jout.out
    assert json.loads(out.out)["alignment_heads"]
    assert out.err.replace(ours, "X") == jout.err.replace(path, "X")
    assert_npz_equal(ours, path)
    params, cfg = convert.load_params(ours, "cpu")
    assert cfg.alignment_heads == tuple(tuple(p) for p in json.loads(out.out)["alignment_heads"])
    assert convert.load_tokenizer(ours) is not None
