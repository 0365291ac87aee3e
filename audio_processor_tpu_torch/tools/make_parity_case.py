"""Build a trained-weight Whisper parity case for ``verify_parity``.

The port of the JAX repository's ``tools/make_parity_case.py``, writing
the same case file.  Run it on a machine with network access and
openai-whisper, then ship the output directory to the machine that runs
the gate::

    python -m audio_processor_tpu_torch.tools.make_parity_case \\
        --wav speech.wav --model tiny --out parity_case/
    python -m audio_processor_tpu_torch.tools.verify_parity --out parity_case/ --whisper tiny

What it does:
  1. transcribes the WAV with the reference openai-whisper (greedy, T=0),
     which downloads the checkpoint, to capture the expected transcript,
  2. copies the multilingual tiktoken rank file from the whisper package,
  3. converts the checkpoint with the port's ``models/whisper/convert``
     into the ``.npz`` format, the vocab embedded,
  4. writes ``case-<model>.json`` (and ``case.json`` for the first model).

Without openai-whisper it prints what to install and returns 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wav", required=True, help="a short speech WAV (16 kHz mono)")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--out", default="parity_case")
    args = ap.parse_args(argv)

    try:
        import whisper  # openai-whisper, the reference engine
    except ImportError:
        print("pip install openai-whisper first (needs network)", file=sys.stderr)
        return 1

    os.makedirs(args.out, exist_ok=True)

    # 1. reference transcription (greedy, to match the default decode)
    ref_model = whisper.load_model(args.model)
    result = ref_model.transcribe(args.wav, temperature=0.0, beam_size=None)

    # 2. the raw .pt checkpoint whisper just downloaded
    ckpt_dir = os.path.expanduser(
        os.environ.get("XDG_CACHE_HOME", "~/.cache") + "/whisper"
    )
    pt_path = os.path.join(ckpt_dir, f"{args.model}.pt")

    # 3. tiktoken rank file from the whisper package assets
    import whisper.tokenizer as wtok

    rank_src = os.path.join(
        os.path.dirname(wtok.__file__), "assets", "multilingual.tiktoken"
    )
    rank_dst = os.path.join(args.out, "multilingual.tiktoken")
    with open(rank_src, "rb") as fin, open(rank_dst, "wb") as fout:
        fout.write(fin.read())

    # 4. convert to the .npz, the vocab embedded so the file alone is
    # servable (Transcriber.from_npz builds the tokenizer from it)
    from ..models.whisper import convert
    from ..models.whisper.tokenizer import BPETokenizer

    npz_path = os.path.join(args.out, f"whisper-{args.model}.npz")
    params, cfg = convert.load_openai_checkpoint(pt_path)
    convert.save_params(
        npz_path, params, cfg, tokenizer=BPETokenizer.from_tiktoken(rank_dst)
    )

    case = {
        "model_npz": os.path.abspath(npz_path),
        "tokenizer": os.path.abspath(rank_dst),
        "wav": os.path.abspath(args.wav),
        "expected_text": result["text"],
        "expected_segments": [
            {"start": s["start"], "end": s["end"], "text": s["text"]}
            for s in result["segments"]
        ],
        "reference_engine": f"openai-whisper {whisper.__version__} / {args.model}",
    }
    # a case file per model (verify_parity gates several from one
    # directory); case.json stays as an alias for the first model
    case_path = os.path.join(args.out, f"case-{args.model}.json")
    with open(case_path, "w") as f:
        json.dump(case, f, indent=2, ensure_ascii=False)
    legacy = os.path.join(args.out, "case.json")
    if not os.path.exists(legacy):
        with open(legacy, "w") as f:
            json.dump(case, f, indent=2, ensure_ascii=False)
    print(f"wrote {case_path}; set APTPU_PARITY_CHECKPOINT={case_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
