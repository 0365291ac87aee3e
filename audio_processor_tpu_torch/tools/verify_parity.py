"""The trained-checkpoint parity gates (WER and DER) for the port.

The port of the JAX repository's ``tools/verify_parity.py``.  The two
gates are functions here, called in-process on the card (``--cpu`` for
the plain PyTorch path), not through pytest:

- ``check_transcript_case``: a converted Whisper checkpoint transcribes
  a recording to the reference engine's text (lower-cased, whitespace
  collapsed), through the port's ``BPETokenizer.from_tiktoken``,
  ``Transcriber.from_npz`` and ``ingest.load_audio``;
- ``check_diarizer_case``: converted pyannote-3.1 weights diarize the
  recording within ``max_der`` (default 1 %) of pyannote's own turns,
  through ``Diarizer.from_npz``.

Both read the case files of the JAX tools (``case-<model>.json`` from
``make_parity_case``, ``diar_case.json`` from ``--prepare``).  A Whisper
case may carry ``"transcriber"``: keyword options for
``Transcriber.from_npz`` (a case made from seeded weights pins float32 and
no temperature fallback there); a case without it runs the defaults.

    # on a machine with network (+ HF_TOKEN for pyannote):
    python -m audio_processor_tpu_torch.tools.verify_parity --prepare \\
        --whisper tiny --pyannote 3.1 --wav real_speech.wav --out parity_case/
    # then on the card:
    python -m audio_processor_tpu_torch.tools.verify_parity --out parity_case/

The record (pass, FAILED or skipped per gate) goes to ``--record``,
by default ``<out>/PARITY_TORCH.json``; the JAX tool's ``PARITY.json`` is
never written.  Exit status 1 when a gate failed or ``--prepare`` could
not prepare a case (openai-whisper or pyannote.audio absent).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..pipeline.diarize import Diarizer
from ..pipeline.ingest import load_audio
from ..runtime.device import resolve_device
from ..utils.metrics import diarization_error_rate


class ParityFailure(AssertionError):
    """A parity gate's check did not hold."""


def _load(case) -> dict:
    if isinstance(case, dict):
        return case
    with open(case) as f:
        return json.load(f)


def _norm(s: str) -> str:
    return " ".join(s.lower().split())


def check_transcript_case(case, device=None) -> dict:
    """The Whisper gate on ``case`` (a path or the loaded dict):
    ``{"text": ...}`` when the transcript equals ``expected_text``, else
    ``ParityFailure``."""
    from ..models.whisper.tokenizer import BPETokenizer
    from ..pipeline.transcribe import Transcriber

    case = _load(case)
    tok = BPETokenizer.from_tiktoken(case["tokenizer"])
    tr = Transcriber.from_npz(case["model_npz"], tokenizer=tok, device=device,
                              **case.get("transcriber", {}))
    out = tr.transcribe(load_audio(case["wav"]), remove_silence=False)
    if _norm(out["text"]) != _norm(case["expected_text"]):
        raise ParityFailure(f"transcript {out['text']!r} != expected {case['expected_text']!r}")
    return {"text": out["text"]}


def check_diarizer_case(case, device=None) -> dict:
    """The diarization gate on ``case``: ``{"der", "max_der", "turns"}``
    when the converted diarizer's DER against the reference turns is at
    most ``max_der``, else ``ParityFailure``."""
    case = _load(case)
    d = Diarizer.from_npz(case["diarizer_npz"], device=device)
    if d.provenance != "converted":
        raise ParityFailure(f"provenance {d.provenance!r}, not 'converted'")
    hyp = d.diarize(load_audio(case["wav"]))
    if not hyp:
        raise ParityFailure("converted diarizer produced zero turns")
    der = diarization_error_rate(case["reference_turns"], hyp)
    max_der = float(case.get("max_der", 0.01))  # BASELINE.md: <=1 % delta
    if der > max_der:
        raise ParityFailure(f"DER {der:.4f} vs the reference exceeds the {max_der:.2%} gate")
    return {"der": der, "max_der": max_der, "turns": len(hyp)}


# ---------------------------------------------------------------------------
# prepare: download + convert (network machine only)
# ---------------------------------------------------------------------------

def _whisper_case_path(out: str, model: str) -> str:
    """Per-model case file, with the single-model name as a fallback so
    older prepared directories keep verifying."""
    case = os.path.join(out, f"case-{model}.json")
    legacy = os.path.join(out, "case.json")
    return case if os.path.exists(case) or not os.path.exists(legacy) else legacy


def _prepare_whisper(args, model: str) -> str | None:
    from . import make_parity_case

    case = _whisper_case_path(args.out, model)
    if os.path.exists(case):
        print(f"whisper {model} case already prepared: {case}")
        return case
    rc = make_parity_case.main(["--wav", args.wav, "--model", model, "--out", args.out])
    case = _whisper_case_path(args.out, model)
    return case if rc == 0 and os.path.exists(case) else None


def _prepare_pyannote(args) -> str | None:
    """Convert pyannote-3.1 checkpoints + capture its reference turns."""
    case = os.path.join(args.out, "diar_case.json")
    if os.path.exists(case):
        print(f"diarizer case already prepared: {case}")
        return case
    try:
        from pyannote.audio import Pipeline
    except ImportError as e:
        print(f"prepare needs pyannote.audio + torch on this machine: {e}",
              file=sys.stderr)
        return None

    token = os.environ.get("HF_TOKEN")
    pipe = Pipeline.from_pretrained(
        f"pyannote/speaker-diarization-{args.pyannote}", use_auth_token=token
    )

    # 1. reference turns from the real pipeline (these are the DER labels:
    #    the gate scores the port against its output)
    ann = pipe(args.wav)
    ref = [
        {"start": round(t.start, 3), "end": round(t.end, 3), "speaker": lbl}
        for t, _, lbl in ann.itertracks(yield_label=True)
    ]

    # 2. convert the two underlying nets into the diarizer pack
    from ..models.diarization import convert as dconvert

    seg_params, _ = dconvert.from_pyannet_state_dict(pipe._segmentation.model.state_dict())
    emb_params, _ = dconvert.from_resnet_state_dict(pipe._embedding.model_.state_dict())
    npz = os.path.join(args.out, f"diarizer-pyannote-{args.pyannote}.npz")
    dconvert.save_diarizer_params(npz, seg_params, emb_params)

    payload = {
        "diarizer_npz": os.path.abspath(npz),
        "wav": os.path.abspath(args.wav),
        "reference_turns": ref,
        "max_der": args.max_der,
        "reference_engine": f"pyannote/speaker-diarization-{args.pyannote}",
    }
    with open(case, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {case}; set APTPU_PARITY_DIARIZER={case}")
    return case


# ---------------------------------------------------------------------------
# verify: run the gates, write the record
# ---------------------------------------------------------------------------

def _run_gate(check, env_var: str, case: str | None, device) -> dict:
    if not case or not os.path.exists(case):
        return {"status": "skipped", "reason": f"{env_var} case not prepared"}
    try:
        detail = check(case, device)
    except Exception as e:  # noqa: BLE001 — every failure is a FAILED gate, recorded
        return {"status": "FAILED", "case": os.path.abspath(case),
                "error": f"{type(e).__name__}: {e}"[-2000:]}
    return {"status": "passed", "case": os.path.abspath(case), **detail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--whisper", default="tiny,medium,large-v3-turbo",
                    help="comma-separated openai-whisper variants to gate — "
                    "the default pins the reference's serving model "
                    "(medium), its fallback tier, and the large-v3-turbo "
                    "family in one --prepare run")
    ap.add_argument("--pyannote", default="3.1",
                    help="pyannote speaker-diarization version")
    ap.add_argument("--wav", help="real speech WAV (prepare step only)")
    ap.add_argument("--out", default="parity_case",
                    help="artifact directory (cases + converted weights)")
    ap.add_argument("--max-der", type=float, default=0.01,
                    help="DER gate vs pyannote output (BASELINE: 1 %%)")
    ap.add_argument("--prepare", action="store_true",
                    help="download/convert checkpoints + capture reference "
                    "outputs (needs network, openai-whisper, pyannote.audio)")
    ap.add_argument("--record", default=None,
                    help="where the record goes (default: <out>/PARITY_TORCH.json)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the gates on the CPU (default: the card, an error without one)")
    args = ap.parse_args(argv)
    if args.record and os.path.basename(args.record) == "PARITY.json":
        ap.error("--record may not be PARITY.json, the JAX tool's record")
    device = resolve_device("cpu" if args.cpu else None)

    os.makedirs(args.out, exist_ok=True)
    models = [m.strip() for m in args.whisper.split(",") if m.strip()]
    wcases = {m: _whisper_case_path(args.out, m) for m in models}
    dcase = os.path.join(args.out, "diar_case.json")

    unprepared = []
    if args.prepare:
        if not args.wav:
            ap.error("--prepare needs --wav (a real speech recording)")
        for m in models:
            case = _prepare_whisper(args, m)
            wcases[m] = case or wcases[m]
            unprepared += [] if case else [f"whisper:{m}"]
        case = _prepare_pyannote(args)
        dcase = case or dcase
        unprepared += [] if case else ["diarization"]

    results = {
        f"whisper:{m}": _run_gate(check_transcript_case, "APTPU_PARITY_CHECKPOINT",
                                  wcases[m], device)
        for m in models
    }
    results["diarization"] = _run_gate(check_diarizer_case, "APTPU_PARITY_DIARIZER",
                                       dcase, device)
    out = args.record or os.path.join(args.out, "PARITY_TORCH.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    print(f"wrote {out}")
    if unprepared:
        print(f"--prepare could not prepare: {', '.join(unprepared)}", file=sys.stderr)
    return 1 if unprepared or any(r["status"] == "FAILED" for r in results.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
