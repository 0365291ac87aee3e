"""Command line for the PyTorch port.

    python -m audio_processor_tpu_torch.cli transcribe meeting.wav --json
    python -m audio_processor_tpu_torch.cli transcribe meeting.wav \\
        --npz small.npz --device cuda

Without --npz the weights are random (seeded): the flow runs end to end,
the text is meaningless.  --device defaults to the card; --device cpu runs
the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import json
import sys


def cmd_transcribe(args) -> None:
    from .pipeline.transcribe import Transcriber

    kw = {}
    if args.language:
        from .models.whisper.tokenizer import language_index

        kw["language"] = language_index(args.language, num_languages=None)
    if args.npz:
        t = Transcriber.from_npz(
            args.npz, tokenizer_path=args.tokenizer, device=args.device, **kw
        )
    else:
        t = Transcriber.random_init(args.model, device=args.device, **kw)
    out = t.transcribe(args.audio, remove_silence=not args.keep_silence)
    if args.json:
        print(json.dumps(out, indent=2))
        return
    for seg in out["segments"]:
        print(f"[{seg['start']:8.2f} – {seg['end']:8.2f}] {seg['text']}")
    print(f"-- {out['duration']:.1f}s audio, {out['rtf_x']:.1f}x realtime", file=sys.stderr)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="audio_processor_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("transcribe", help="transcribe an audio file")
    t.add_argument("audio")
    t.add_argument("--model", default="tiny", help="preset for random weights")
    t.add_argument("--npz", help="checkpoint converted by the JAX package's convert tool")
    t.add_argument("--tokenizer", help="tokenizer asset overriding the embedded vocab")
    t.add_argument("--device", default=None, help="cuda (default) or cpu")
    t.add_argument("--language", help="ISO code (e.g. en); default: auto-detect")
    t.add_argument("--keep-silence", action="store_true")
    t.add_argument("--json", action="store_true")
    t.set_defaults(fn=cmd_transcribe)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
