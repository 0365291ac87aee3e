"""The port's CLI against the JAX package's, on the CPU.

``transcribe``'s flags must build the same Transcriber keyword arguments in
both (the port adds only ``device``) and refuse the same combinations; on
one set of weights, every ``--output-format`` must write the same files
(the JSON once ``rtf_x`` is masked, its decode statistics within 1e-4) and ``stream``, ``detect-language``,
``wer`` and ``der`` must print the same lines.  The subtitle writers are
held to JAX's on the cases of ``tests/test_writers.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import jax

from audio_processor_tpu import cli as jcli
from audio_processor_tpu.pipeline.transcribe import Transcriber as JTranscriber
from audio_processor_tpu.utils import writers as jwriters
from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.models.whisper import convert, model
from audio_processor_tpu_torch.models.whisper.config import WhisperConfig
from audio_processor_tpu_torch.pipeline.transcribe import Transcriber
from audio_processor_tpu_torch.runtime.device import set_full_fp32
from audio_processor_tpu_torch.utils import wavio, writers

set_full_fp32()


class _Captured(Exception):
    pass


def _capture(monkeypatch, module, cls, argv, sub="transcribe"):
    """Run a subcommand until it builds its Transcriber: its keyword
    arguments, or the SystemExit message it refused with."""
    seen = {}

    def spy(klass, *a, **kw):
        seen.update(kw)
        raise _Captured

    monkeypatch.setattr(cls, "random_init", classmethod(spy))
    try:
        module.main([sub, "/nonexistent.wav", "--model", "test", *argv])
    except _Captured:
        return seen
    except SystemExit as e:
        return ("exit", str(e.code))
    raise AssertionError("the subcommand neither built a Transcriber nor exited")


FLAG_CASES = {
    "defaults": [],
    "thresholds": ["--compression-ratio-threshold", "3.0", "--logprob-threshold", "None",
                   "--no-speech-threshold", "0.5"],
    "ladder": ["--temperature-increment-on-fallback", "0.5"],
    "ladder-from-base": ["--temperature", "0.4", "--temperature-increment-on-fallback", "0.3"],
    "single-decode": ["--temperature-increment-on-fallback", "None"],
    "base-temperature": ["--temperature", "0.4"],
    "bad-increment": ["--temperature-increment-on-fallback", "0"],
    "decoding": ["--beam", "3", "--best-of", "2", "--patience", "2", "--length-penalty", "1",
                 "--suppress-tokens", "-1,5,7", "--task", "translate", "--language", "de",
                 "--initial-prompt", "hi", "--carry-initial-prompt", "--prefix", "so",
                 "--without-timestamps", "--max-initial-timestamp", "-1", "--condition"],
    "max-initial": ["--max-initial-timestamp", "2.5"],
    "words": ["--word-timestamps", "--prepend-punctuations", "¿(", "--append-punctuations", ".,",
              "--hallucination-silence-threshold", "2.0", "--highlight-words",
              "--max-line-width", "40", "--max-line-count", "2", "--max-words-per-line", "3"],
    "threshold-without-words": ["--hallucination-silence-threshold", "2.0"],
    "highlight-without-words": ["--highlight-words"],
    "line-width-without-words": ["--max-line-width", "20"],
    "line-count-without-words": ["--max-line-count", "2"],
    "words-per-line-without-words": ["--max-words-per-line", "2"],
    "all-without-output-dir": ["--output-format", "all"],
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_transcribe_flags_build_what_jax_builds(monkeypatch, case):
    argv = FLAG_CASES[case]
    ref = _capture(monkeypatch, jcli, JTranscriber, argv)
    ours = _capture(monkeypatch, cli, Transcriber, [*argv, "--device", "cpu"])
    if isinstance(ref, dict):
        assert ours.pop("device") == "cpu"
    assert ours == ref


def test_several_inputs_need_an_output_dir(tmp_path):
    for mod in (jcli, cli):
        with pytest.raises(SystemExit, match="output-dir"):
            mod.main(["transcribe", "a.wav", "b.wav", "--model", "test"])


@pytest.fixture(scope="module")
def shared():
    """One set of test-config weights for both packages, float32."""
    jt = JTranscriber.random_init("test", compute_dtype="float32", max_new_tokens=12)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jt.params), "cpu")
    cfg = WhisperConfig(**{k: getattr(jt.cfg, k) for k in WhisperConfig.__dataclass_fields__})
    return jt, params, cfg


class SpacedLetters:
    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(" " if int(i) % 5 == 0 else chr(97 + int(i) % 26) for i in ids)


def _serve_shared(monkeypatch, shared):
    """Both packages' random_init hand out Transcribers on the shared
    weights, with the CLI's options applied."""
    jt, params, cfg = shared
    common = dict(tokenizer=SpacedLetters(), no_speech_threshold=None, enable_fallback=False)

    def jspy(klass, name="tiny", **kw):
        return dataclasses.replace(jt, **dict(common, **kw))

    def spy(klass, name="tiny", device=None, **kw):
        return Transcriber(params=params, cfg=cfg, compute_dtype="float32", max_new_tokens=12,
                           device=device, **dict(common, **kw))

    monkeypatch.setattr(JTranscriber, "random_init", classmethod(jspy))
    monkeypatch.setattr(Transcriber, "random_init", classmethod(spy))


@pytest.fixture
def wavs(tmp_path, speech_like_audio):
    paths = []
    for name, audio in (("a", np.concatenate([speech_like_audio] * 4)), ("b", speech_like_audio)):
        p = str(tmp_path / f"{name}.wav")
        wavio.write_wav(p, audio, 16_000)
        paths.append(p)
    return paths


def _assert_close(ours, ref, path="out"):
    """Equal, but floats (decode statistics summed in another order)
    within 1e-4."""
    if isinstance(ref, float):
        assert ours == pytest.approx(ref, abs=1e-4), path
    elif isinstance(ref, dict):
        assert sorted(ours) == sorted(ref), path
        for k in ref:
            _assert_close(ours[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(ours) == len(ref), path
        for i, (o, r) in enumerate(zip(ours, ref)):
            _assert_close(o, r, f"{path}[{i}]")
    else:
        assert ours == ref, path


def _read_outputs(d):
    out = {}
    for p in sorted(d.iterdir()):
        text = p.read_text(encoding="utf-8")
        if p.suffix == ".json":
            data = json.loads(text)
            data.pop("rtf_x")
            text = data
        out[p.name] = text
    return out


@pytest.mark.parametrize("extra", [[], ["--word-timestamps", "--highlight-words",
                                        "--max-line-width", "12"]])
def test_output_dir_files_equal_jax(monkeypatch, shared, wavs, tmp_path, extra):
    """Two inputs (one shared-slab batch), every format: the same files."""
    _serve_shared(monkeypatch, shared)
    dirs = {name: tmp_path / name for name in ("jax", "port")}
    base = ["transcribe", *wavs, "--keep-silence", "--output-format", "all", *extra]
    jcli.main([*base, "--output-dir", str(dirs["jax"])])
    cli.main([*base, "--output-dir", str(dirs["port"]), "--device", "cpu"])
    ref, ours = _read_outputs(dirs["jax"]), _read_outputs(dirs["port"])
    assert sorted(ours) == sorted(f"{s}.{e}" for s in "ab" for e in ("txt", "srt", "vtt",
                                                                     "tsv", "json"))
    _assert_close(ours, ref)
    assert ours["a.json"]["segments"]
    if extra:
        assert ours["a.json"]["words"] and "<u>" in ours["a.srt"]


@pytest.mark.parametrize("fmt", ["json", "srt", "vtt", "tsv", "txt", "text"])
def test_stdout_formats_equal_jax(monkeypatch, shared, wavs, capsys, fmt):
    _serve_shared(monkeypatch, shared)
    argv = ["transcribe", wavs[1], "--output-format", fmt, "--clip-timestamps", "1,6,7"]
    jcli.main(argv)
    ref = capsys.readouterr().out
    cli.main([*argv, "--device", "cpu"])
    ours = capsys.readouterr().out
    assert ours
    if fmt == "json":
        ref, ours = json.loads(ref), json.loads(ours)
        ref.pop("rtf_x"), ours.pop("rtf_x")
    _assert_close(ours, ref)


def test_verbose_streams_the_same_lines(monkeypatch, shared, wavs, capsys):
    _serve_shared(monkeypatch, shared)
    argv = ["transcribe", wavs[0], "--json", "--keep-silence", "--verbose"]
    jcli.main(argv)
    ref = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[")]
    cli.main([*argv, "--device", "cpu"])
    ours = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[")]
    assert ours == ref and ours


def test_stream_prints_what_jax_prints(monkeypatch, shared, wavs, capsys):
    _serve_shared(monkeypatch, shared)
    argv = ["stream", wavs[0], "--block-s", "7.5"]
    jcli.main(argv)
    ref = capsys.readouterr().out
    cli.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out == ref and ref
    with pytest.raises(SystemExit):
        cli.main(["stream", wavs[0], "--block-s", "0", "--device", "cpu"])


def test_detect_language_prints_what_jax_prints(monkeypatch, wavs, capsys):
    """A multilingual toy model on both sides; JSON and plain forms."""
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                n_audio_layer=1, n_vocab=51865, n_text_ctx=64, n_text_state=64,
                n_text_head=2, n_text_layer=1)
    cfg = WhisperConfig(name="ml", **dims)
    params = model.init_params(cfg, torch.Generator().manual_seed(12))
    jtree = convert._unflatten({
        k: (t.numpy().transpose(2, 1, 0) if k in convert._CONV_KEYS else t.numpy())
        for k, t in convert._flatten(params).items()
    })
    from audio_processor_tpu.models.whisper.config import WhisperConfig as JConfig

    jt = JTranscriber(params=jtree, cfg=JConfig(name="ml", **dims), compute_dtype="float32")
    monkeypatch.setattr(JTranscriber, "random_init", classmethod(lambda k, name, **kw: jt))
    monkeypatch.setattr(Transcriber, "random_init", classmethod(
        lambda k, name, device=None, **kw: Transcriber(
            params=params, cfg=cfg, compute_dtype="float32", device=device)))
    for extra in (["--json"], []):
        jcli.main(["detect-language", wavs[0], *extra])
        ref = capsys.readouterr()
        cli.main(["detect-language", wavs[0], "--device", "cpu", *extra])
        ours = capsys.readouterr()
        if extra:
            r, o = json.loads(ref.out), json.loads(ours.out)
            assert o["language"] == r["language"]
            assert list(o["probabilities"]) == list(r["probabilities"])
            np.testing.assert_allclose(list(o["probabilities"].values()),
                                       list(r["probabilities"].values()), atol=1e-5)
        else:
            assert ours.out == ref.out and ours.err == ref.err


def test_wer_and_der_print_what_jax_prints(tmp_path, capsys):
    (tmp_path / "ref.txt").write_text("the quick brown fox jumps")
    (tmp_path / "hyp.txt").write_text("the quick brown dog jumps high")
    ref = [{"start": 0.0, "end": 2.0, "speaker": "S0"}, {"start": 2.0, "end": 4.5, "speaker": "S1"},
           {"start": 5.0, "end": 6.0, "speaker": "S0"}]
    hyp = [{"start": 0.1, "end": 2.2, "speaker": "A"}, {"start": 2.2, "end": 4.0, "speaker": "A"},
           {"start": 4.0, "end": 6.5, "speaker": "B"}]
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    (tmp_path / "hyp.json").write_text(json.dumps(hyp))
    for argv in (["wer", "ref.txt", "hyp.txt"], ["der", "ref.json", "hyp.json"],
                 ["der", "ref.json", "hyp.json", "--collar", "0.0"]):
        argv = [argv[0]] + [str(tmp_path / a) if "." in a and "json" in a or a.endswith(".txt")
                            else a for a in argv[1:]]
        jcli.main(argv)
        want = capsys.readouterr().out
        cli.main(argv)
        assert capsys.readouterr().out == want and want.startswith(argv[0].upper())


# -- the subtitle writers, on the cases of tests/test_writers.py -------------

def _words(*spec):
    return [{"word": w, "start": s, "end": e} for w, s, e in spec]


WRITER_SEGMENTS = {
    "plain": [{"start": 0.0, "end": 2.5, "text": "Hello there."},
              {"start": 2.5, "end": 5.123, "text": "General --> Kenobi."}],
    "hours": [{"start": 3599.5, "end": 3601.25, "text": "late"}],
    "negative": [{"start": -0.2, "end": 1.0, "text": "x"}],
    "words": [{"start": 0.0, "end": 3.0, "text": " one two three four five",
               "words": _words((" one", 0.0, 0.5), (" two", 0.5, 1.0), (" three", 1.0, 1.6),
                               (" four", 1.6, 2.2), (" five", 2.2, 3.0))},
              {"start": 3.0, "end": 4.0, "text": " six", "words": []},
              {"start": 4.0, "end": 6.0, "text": " seven eight",
               "words": _words((" seven", 4.0, 5.0), (" eight", 5.0, 6.0))}],
}
WRITER_OPTIONS = {
    "none": {},
    "highlight": dict(highlight_words=True),
    "words-per-line": dict(max_words_per_line=2),
    "width-count": dict(max_line_width=10, max_line_count=1),
    "width": dict(max_line_width=12),
}


@pytest.mark.parametrize("fmt", ["txt", "srt", "vtt", "tsv"])
@pytest.mark.parametrize("segments", list(WRITER_SEGMENTS))
@pytest.mark.parametrize("option", list(WRITER_OPTIONS))
def test_writers_equal_jax(fmt, segments, option):
    segs = WRITER_SEGMENTS[segments]
    opts = WRITER_OPTIONS[option] if fmt in ("srt", "vtt") else {}
    assert writers.format_segments(segs, fmt, **opts) == jwriters.format_segments(segs, fmt, **opts)


def test_unknown_writer_format_raises_as_jax():
    for mod in (writers, jwriters):
        with pytest.raises(ValueError):
            mod.format_segments([], "docx")
