"""The trained-checkpoint parity gates of the port (``tools/verify_parity``).

The two env-gated gates are the port's counterparts of the JAX suite's
``test_parity_generate.py::test_real_checkpoint_transcript`` and
``test_parity_diarization.py::test_real_checkpoint_der``: they run
``check_transcript_case`` / ``check_diarizer_case`` on the CPU and skip
while ``APTPU_PARITY_CHECKPOINT`` / ``APTPU_PARITY_DIARIZER`` name no case
(no checkpoint enters a machine without network).

Seeded cases, built here, hold the gates themselves: a Whisper case from
a ``.pt`` of the converter tests' recipe (a seeded ``transformers``
Whisper at the "test" preset's widths under openai's names) through the
port's ``convert-whisper``, its expected text from the JAX
``Transcriber`` on the same ``.npz`` (float32, no fallback, 16 tokens,
pinned in the case); a diarizer case from seeded PyanNet and ResNet34
state dicts through ``convert-diarizer``, its reference turns from the
JAX ``Diarizer.from_npz`` on a 12 s synthetic meeting.  Each passes, and
fails once its label is changed.  No jax at module level: the file also
imports where there is none (the seeded cases then skip).
"""
import base64
import itertools
import json
import os
import sys

import numpy as np
import pytest
import torch

from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.tools import make_parity_case
from audio_processor_tpu_torch.tools import verify_parity as vp
from audio_processor_tpu_torch.utils import wavio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the Transcriber options the seeded Whisper case pins: float32 and no
# temperature fallback, so the JAX and port decodes are the same argmaxes
SEEDED_TRANSCRIBER = {"compute_dtype": "float32", "enable_fallback": False,
                      "max_new_tokens": 16}


def _case_from_env(var):
    path = os.environ.get(var)
    if not path or not os.path.exists(path):
        pytest.skip(f"{var} names no case: no trained checkpoint on this machine")
    return path


def test_real_checkpoint_transcript():
    """A converted trained Whisper transcribes the case's recording to the
    reference engine's text (``tools/make_parity_case`` builds the case)."""
    out = vp.check_transcript_case(_case_from_env("APTPU_PARITY_CHECKPOINT"), device="cpu")
    assert out["text"]


def test_real_checkpoint_der():
    """Converted pyannote-3.1 weights within the case's DER gate (1 % by
    default) of pyannote's own turns (``verify_parity --prepare``)."""
    out = vp.check_diarizer_case(_case_from_env("APTPU_PARITY_DIARIZER"), device="cpu")
    assert out["der"] <= out["max_der"]


# ---------------------------------------------------------------------------
# Seeded cases
# ---------------------------------------------------------------------------

def _rank_file(path, n_text):
    """A tiktoken rank file covering every text id of a tiny vocab: the
    256 bytes, then pairs (a space, a digit or a letter, then a letter)."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    toks = [bytes([b]) for b in range(256)]
    toks += [(a + b).encode() for a, b in itertools.product(" 0123456789" + letters, letters)]
    with open(path, "wb") as f:
        for rank, tok in enumerate(toks[:n_text]):
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")


def _speech_wav(path, seconds, seed):
    sr = 16_000
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6)) * 0.3
    sig = sig + np.random.default_rng(seed).normal(0, 0.01, len(t))
    wavio.write_wav(path, sig.astype(np.float32), sr)


@pytest.fixture(scope="module")
def whisper_case(tmp_path_factory):
    pytest.importorskip("jax")
    pytest.importorskip("transformers")
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    from audio_processor_tpu.models.whisper.tokenizer import BPETokenizer as JBPETokenizer
    from audio_processor_tpu.pipeline.ingest import load_audio as jload_audio
    from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber
    from audio_processor_tpu_torch.models.whisper.config import get_config
    from audio_processor_tpu_torch.models.whisper.decode import SpecialTokens
    from test_torch_convert import _openai_state_dict

    d = tmp_path_factory.mktemp("whisper_case")
    cfg = get_config("test")
    torch.manual_seed(0)
    hf = WhisperForConditionalGeneration(HFConfig(
        vocab_size=cfg.n_vocab, num_mel_bins=cfg.n_mels, encoder_layers=cfg.n_audio_layer,
        encoder_attention_heads=cfg.n_audio_head, decoder_layers=cfg.n_text_layer,
        decoder_attention_heads=cfg.n_text_head, d_model=cfg.n_audio_state,
        max_source_positions=cfg.n_audio_ctx, max_target_positions=cfg.n_text_ctx,
        encoder_ffn_dim=4 * cfg.n_audio_state, decoder_ffn_dim=4 * cfg.n_text_state,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=3,
        suppress_tokens=[], begin_suppress_tokens=[])).eval()
    dims = {k: getattr(cfg, k) for k in ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head",
                                         "n_audio_layer", "n_vocab", "n_text_ctx",
                                         "n_text_state", "n_text_head", "n_text_layer")}
    pt, npz, ranks, wav = (str(d / n) for n in ("seeded.pt", "seeded.npz", "seeded.tiktoken",
                                                 "speech.wav"))
    torch.save({"dims": dims, "model_state_dict": _openai_state_dict(hf.state_dict())}, pt)
    _rank_file(ranks, SpecialTokens.for_config(cfg).eot)
    cli.main(["convert-whisper", pt, npz, "--tokenizer", ranks])
    _speech_wav(wav, 10.0, 0)
    ref = JTranscriber.from_npz(npz, tokenizer=JBPETokenizer.from_tiktoken(ranks),
                                **SEEDED_TRANSCRIBER)
    text = ref.transcribe(jload_audio(wav), remove_silence=False)["text"]
    assert text.strip()  # the rank file covers every text id: letters come out
    return {"model_npz": npz, "tokenizer": ranks, "wav": wav, "expected_text": text,
            "transcriber": SEEDED_TRANSCRIBER, "reference_engine": "JAX Transcriber, seeded"}


@pytest.fixture(scope="module")
def diarizer_case(tmp_path_factory):
    pytest.importorskip("jax")
    from audio_processor_tpu.pipeline.diarize import Diarizer as JDiarizer
    from audio_processor_tpu.pipeline.ingest import load_audio as jload_audio
    from audio_processor_tpu_torch.tools import make_bundled_diarizer as tool
    from test_torch_convert import _pyannet_state_dict, _resnet_state_dict

    d = tmp_path_factory.mktemp("diarizer_case")
    rng = np.random.default_rng(0)
    seg_pt, emb_pt, npz, wav = (str(d / n) for n in ("seg.ckpt", "emb.pt", "diar.npz", "m.wav"))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in _pyannet_state_dict(rng).items()}},
               seg_pt)
    torch.save({k: torch.from_numpy(v) for k, v in _resnet_state_dict(rng, blocks=(3, 4, 6, 3))
                .items()}, emb_pt)
    cli.main(["convert-diarizer", seg_pt, emb_pt, npz])
    mrng = np.random.default_rng(5)
    audio, _ = tool.make_meeting(mrng, tool.sample_f0s(mrng), duration_s=12.0)
    wavio.write_wav(wav, audio, 16_000)
    turns = JDiarizer.from_npz(npz).diarize(jload_audio(wav))
    assert turns
    return {"diarizer_npz": npz, "wav": wav, "reference_turns": turns, "max_der": 0.01,
            "reference_engine": "JAX Diarizer.from_npz, seeded"}


def test_seeded_whisper_case_passes(whisper_case, tmp_path):
    path = str(tmp_path / "case-seeded.json")
    with open(path, "w") as f:
        json.dump(whisper_case, f)
    assert vp.check_transcript_case(path, device="cpu")["text"] == whisper_case["expected_text"]


def test_seeded_whisper_case_fails_on_a_changed_text(whisper_case):
    changed = dict(whisper_case, expected_text=whisper_case["expected_text"] + " x")
    with pytest.raises(vp.ParityFailure, match="transcript"):
        vp.check_transcript_case(changed, device="cpu")


def test_seeded_diarizer_case_passes(diarizer_case):
    out = vp.check_diarizer_case(diarizer_case, device="cpu")
    assert out["der"] <= 0.01 and out["turns"] == len(diarizer_case["reference_turns"])


def test_seeded_diarizer_case_fails_on_changed_turns(diarizer_case):
    changed = dict(diarizer_case, reference_turns=[{"start": 0.0, "end": 3.0, "speaker": "A"},
                                                   {"start": 6.0, "end": 9.0, "speaker": "B"}])
    with pytest.raises(vp.ParityFailure, match="DER"):
        vp.check_diarizer_case(changed, device="cpu")


# ---------------------------------------------------------------------------
# The tools' entry points
# ---------------------------------------------------------------------------

def _parity_json():
    with open(os.path.join(REPO, "PARITY.json"), "rb") as f:
        return f.read()


def test_verify_parity_records_skipped_gates_without_cases(tmp_path, capsys):
    before = _parity_json()
    assert vp.main(["--cpu", "--out", str(tmp_path), "--whisper", "tiny,medium"]) == 0
    with open(tmp_path / "PARITY_TORCH.json") as f:
        record = json.load(f)
    assert record == {
        "whisper:tiny": {"status": "skipped", "reason": "APTPU_PARITY_CHECKPOINT case not prepared"},
        "whisper:medium": {"status": "skipped",
                           "reason": "APTPU_PARITY_CHECKPOINT case not prepared"},
        "diarization": {"status": "skipped", "reason": "APTPU_PARITY_DIARIZER case not prepared"},
    }
    assert _parity_json() == before
    with pytest.raises(SystemExit):
        vp.main(["--cpu", "--out", str(tmp_path), "--record", str(tmp_path / "PARITY.json")])
    assert "PARITY.json" in capsys.readouterr().err


def test_verify_parity_runs_the_cases_it_finds(whisper_case, diarizer_case, tmp_path):
    """Cases in ``--out`` under the JAX tools' names: passed; a changed
    label: FAILED and exit status 1."""
    with open(tmp_path / "case-seeded.json", "w") as f:
        json.dump(whisper_case, f)
    with open(tmp_path / "diar_case.json", "w") as f:
        json.dump(diarizer_case, f)
    record = str(tmp_path / "r.json")
    assert vp.main(["--cpu", "--out", str(tmp_path), "--whisper", "seeded", "--record", record]) == 0
    with open(record) as f:
        got = json.load(f)
    assert got["whisper:seeded"]["status"] == got["diarization"]["status"] == "passed"
    with open(tmp_path / "case-seeded.json", "w") as f:
        json.dump(dict(whisper_case, expected_text="something else"), f)
    assert vp.main(["--cpu", "--out", str(tmp_path), "--whisper", "seeded", "--record", record]) == 1
    with open(record) as f:
        got = json.load(f)
    assert got["whisper:seeded"]["status"] == "FAILED" and "ParityFailure" in got["whisper:seeded"]["error"]
    assert got["diarization"]["status"] == "passed"


def test_prepare_without_the_reference_engines_says_so(tmp_path, monkeypatch, capsys):
    """Neither openai-whisper nor pyannote.audio here: each prepare step
    says what it needs, nothing is downloaded, the gates are skipped and
    the exit status is non-zero."""
    monkeypatch.setitem(sys.modules, "whisper", None)
    monkeypatch.setitem(sys.modules, "pyannote", None)
    monkeypatch.setitem(sys.modules, "pyannote.audio", None)
    wav = str(tmp_path / "a.wav")
    _speech_wav(wav, 1.0, 1)
    assert make_parity_case.main(["--wav", wav, "--out", str(tmp_path / "mpc")]) == 1
    assert "openai-whisper" in capsys.readouterr().err
    assert vp.main(["--cpu", "--prepare", "--wav", wav, "--out", str(tmp_path / "vp"),
                    "--whisper", "tiny"]) == 1
    err = capsys.readouterr().err
    assert "openai-whisper" in err and "pyannote.audio" in err
    with open(tmp_path / "vp" / "PARITY_TORCH.json") as f:
        assert {r["status"] for r in json.load(f).values()} == {"skipped"}
