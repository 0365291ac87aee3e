"""Command line for the PyTorch port.

    python -m audio_processor_tpu_torch.cli transcribe meeting.wav --json
    python -m audio_processor_tpu_torch.cli transcribe meeting.wav \\
        --npz small.npz --device cuda --beam 5 --condition

    python -m audio_processor_tpu_torch.cli diarize meeting.wav --json
    python -m audio_processor_tpu_torch.cli process meeting.wav --model-path small.npz

Without --npz (--model-path for ``process``) the weights are random
(seeded): the flow runs end to end, the text is meaningless.  ``diarize``
serves the repo's bundled synthetic-pretrained nets (random weights when
they are absent).  ``process`` runs the full 9-stage meeting job on a local
file, with no Drive, LLM or Notion, and prints the job's status as JSON.
--device defaults to the card; --device cpu runs the plain PyTorch path.

Sharded serving, one process a rank (``torchrun`` sets the topology; rank 0
prints the result):

    torchrun --nproc-per-node 4 -m audio_processor_tpu_torch.cli transcribe \
        meeting.wav --model small --model-parallel 2 --json
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
    # decoding options, as the JAX package's CLI maps them
    if args.beam:
        kw["beam_size"] = args.beam
    for name in ("best_of", "patience", "length_penalty"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    for name in ("initial_prompt", "prefix"):
        if getattr(args, name):
            kw[name] = getattr(args, name)
    if args.carry_initial_prompt:
        kw["carry_initial_prompt"] = True
    if args.condition:
        kw["condition_on_previous_text"] = True
    mesh = None
    if args.model_parallel:
        from .parallel import multihost

        multihost.initialize(device=args.device)
        mesh = kw["mesh"] = multihost.make_multihost_mesh(args.model_parallel, device=args.device)
    if args.npz:
        t = Transcriber.from_npz(
            args.npz, tokenizer_path=args.tokenizer, device=args.device, **kw
        )
    else:
        t = Transcriber.random_init(args.model, device=args.device, **kw)
    out = t.transcribe(args.audio, remove_silence=not args.keep_silence)
    if mesh is not None:
        multihost.shutdown()
        if mesh.data_rank or mesh.model_rank:
            return  # every rank holds the same result; rank 0 prints it
    if args.json:
        print(json.dumps(out, indent=2))
        return
    for seg in out["segments"]:
        print(f"[{seg['start']:8.2f} – {seg['end']:8.2f}] {seg['text']}")
    print(f"-- {out['duration']:.1f}s audio, {out['rtf_x']:.1f}x realtime", file=sys.stderr)


def cmd_diarize(args) -> None:
    from .models.diarization import checkpoint, embedding
    from .pipeline import ingest
    from .pipeline.diarize import Diarizer

    kw = {"device": args.device}
    if args.min_cluster_size:
        kw["min_cluster_size"] = args.min_cluster_size
    if args.embedding_path:
        tree, emb_cfg = checkpoint.load_embedding_params(args.embedding_path)
        kw.update(emb_params=embedding.params_from_jax(tree, emb_cfg), emb_cfg=emb_cfg)
    if args.segmentation_path:
        d = Diarizer.from_tpu_segmentation(args.segmentation_path, **kw)
    else:
        # the serving default ladder: the bundled checkpoints, else random weights
        d = Diarizer.bundled(**kw) or Diarizer.random_init(**kw)
    turns = d.diarize(
        ingest.load_audio(args.audio),
        num_speakers=args.num_speakers,
        min_speakers=args.min_speakers,
        max_speakers=args.max_speakers,
    )
    if args.json:
        print(json.dumps(turns, indent=2))
    else:
        for t in turns:
            print(f"[{t['start']:8.2f} – {t['end']:8.2f}] {t['speaker']}")


def cmd_process(args) -> None:
    """Run the full 9-stage meeting job on a local file (no SaaS)."""
    import time

    from .pipeline.diarize import Diarizer
    from .pipeline.meeting import MeetingProcessor, build_failure_result
    from .pipeline.transcribe import Transcriber
    from .runtime.job_engine import JobEngine

    transcriber = (
        Transcriber.from_npz(args.model_path, tokenizer_path=args.tokenizer, device=args.device)
        if args.model_path
        else Transcriber.random_init(args.model, device=args.device)
    )
    diarizer = None
    if not args.no_diarization:
        diarizer = (Diarizer.bundled(device=args.device)
                    or Diarizer.random_init(device=args.device))
    proc = MeetingProcessor(transcriber=transcriber, diarizer=diarizer)
    engine = JobEngine(max_workers=1)
    engine.create_job("cli", file_id=args.audio)
    engine.submit("cli", lambda ctx: proc.process(ctx, args.audio),
                  failure_result=build_failure_result)
    while True:
        st = engine.get_job_status("cli")
        print(f"\r{st['progress']:3d}% {st.get('message','')}        ",
              end="", file=sys.stderr)
        if st["status"] in ("completed", "failed", "cancelled"):
            break
        time.sleep(0.3)
    print(file=sys.stderr)
    print(json.dumps(st, indent=2))
    engine.shutdown(wait=False)


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
    t.add_argument("--beam", type=int, default=0, help="beam size (0 = greedy)")
    t.add_argument("--patience", type=float, default=None,
                   help="beam patience (openai's patience; default 1.0)")
    t.add_argument("--length-penalty", dest="length_penalty", type=float, default=None,
                   help="beam ranking exponent, Google-NMT form (default: average logprob)")
    t.add_argument("--best-of", dest="best_of", type=int, default=None,
                   help="sampling candidates on T>0 decodes (openai's best_of; default 5)")
    t.add_argument("--initial-prompt", dest="initial_prompt",
                   help="text context for the first window (openai's initial_prompt)")
    t.add_argument("--carry-initial-prompt", dest="carry_initial_prompt", action="store_true",
                   help="prompt EVERY window with --initial-prompt (openai's carry_initial_prompt)")
    t.add_argument("--prefix", help="text the decode continues from, left out of the output "
                   "(openai's DecodingOptions.prefix)")
    t.add_argument("--condition", action="store_true",
                   help="condition each window on the previous windows' text "
                   "(openai's condition_on_previous_text, in window groups)")
    t.add_argument("--model-parallel", dest="model_parallel", type=int, default=0,
                   help="serve on a (data, model) mesh over the ranks torchrun (or the "
                   "APTPU_* env) starts, heads split over this many ranks")
    t.set_defaults(fn=cmd_transcribe)

    d = sub.add_parser("diarize", help="diarize an audio file")
    d.add_argument("--segmentation-path", dest="segmentation_path",
                   help="trained TPU-first segmentation .npz (the JAX package's "
                   "train-segmentation)")
    d.add_argument("audio")
    d.add_argument("--json", action="store_true")
    d.add_argument("--embedding-path", dest="embedding_path",
                   help="trained speaker-embedding .npz (the JAX package's train-embedding)")
    d.add_argument("--min-cluster-size", dest="min_cluster_size", type=int, default=0,
                   help="dissolve speaker clusters with fewer crops than this "
                   "(pyannote-3.1's min_cluster_size; 0 = off)")
    d.add_argument("--num-speakers", dest="num_speakers", type=int,
                   help="exact speaker count (pyannote's num_speakers; "
                   "exclusive with --min/--max-speakers)")
    d.add_argument("--min-speakers", dest="min_speakers", type=int,
                   help="lower bound on the speaker count")
    d.add_argument("--max-speakers", dest="max_speakers", type=int,
                   help="upper bound on the speaker count")
    d.add_argument("--device", default=None, help="cuda (default) or cpu")
    d.set_defaults(fn=cmd_diarize)

    p = sub.add_parser("process", help="full meeting pipeline on a local file")
    p.add_argument("audio")
    p.add_argument("--model", default="tiny", help="preset for random weights")
    p.add_argument("--model-path", dest="model_path",
                   help="checkpoint converted by the JAX package's convert tool")
    p.add_argument("--tokenizer", help="tokenizer asset overriding the "
                   "checkpoint's embedded vocab")
    p.add_argument("--no-diarization", dest="no_diarization", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_process)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
