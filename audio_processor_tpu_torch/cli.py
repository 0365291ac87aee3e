"""Command line for the PyTorch port.

    python -m audio_processor_tpu_torch.cli transcribe meeting.wav --json
    python -m audio_processor_tpu_torch.cli transcribe a.wav b.wav --output-dir out \\
        --output-format all --word-timestamps --model-path small.npz
    python -m audio_processor_tpu_torch.cli stream meeting.wav --block-s 1
    python -m audio_processor_tpu_torch.cli detect-language meeting.wav --json
    python -m audio_processor_tpu_torch.cli wer ref.txt hyp.txt
    python -m audio_processor_tpu_torch.cli der ref.json hyp.json

    python -m audio_processor_tpu_torch.cli diarize meeting.wav --json
    python -m audio_processor_tpu_torch.cli process meeting.wav --model-path small.npz

``transcribe`` takes the JAX package's flags (openai-whisper's CLI
options).  Without --model-path (--npz) the weights are random (seeded):
the flow runs end to end, the text is meaningless.  ``diarize`` serves the
repo's bundled synthetic-pretrained nets (random weights when they are
absent).  ``process`` runs the full 9-stage meeting job on a local file,
with no Drive, LLM or Notion, and prints the job's status as JSON.
--device defaults to the card; --device cpu runs the plain PyTorch path.

Sharded serving, one process a rank (``torchrun`` sets the topology; rank 0
prints the result):

    torchrun --nproc-per-node 4 -m audio_processor_tpu_torch.cli transcribe \\
        meeting.wav --model small --model-parallel 2 --json
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .utils.options import fallback_ladder
from .utils.options import optional_float as _optional_float


# argparse default meaning "keep the Transcriber's own default": None is
# itself meaningful for the threshold options (openai's optional_float:
# the string "None" turns the check off)
_KEEP = object()


def _language_kw(args) -> dict:
    if not args.language:
        return {}
    from .models.whisper.tokenizer import language_index

    return {"language": language_index(args.language, num_languages=None)}


def _make_transcriber(args, **kw):
    """The Transcriber of a subcommand: the converted checkpoint of
    --model-path, else random weights of --model, on --device."""
    from .pipeline.transcribe import Transcriber

    if args.model_path:
        return Transcriber.from_npz(
            args.model_path, tokenizer_path=args.tokenizer, device=args.device, **kw
        )
    return Transcriber.random_init(args.model, device=args.device, **kw)


def transcribe_kwargs(args) -> dict:
    """The Transcriber options of ``transcribe``'s flags, mapped as the JAX
    package's CLI maps them; raises SystemExit on a combination it refuses."""
    if not args.word_timestamps:
        # openai's CLI refuses word-level subtitle options without
        # word_timestamps rather than silently writing plain cues
        for flag, val in (
            ("--highlight-words", args.highlight_words),
            ("--max-line-width", args.max_line_width),
            ("--max-line-count", args.max_line_count),
            ("--max-words-per-line", args.max_words_per_line),
        ):
            if val:
                raise SystemExit(f"{flag} requires --word-timestamps")
    kw = _language_kw(args)
    if args.beam:
        kw["beam_size"] = args.beam
    for name in ("best_of", "patience"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    if args.suppress_tokens is not None:
        kw["suppress_tokens"] = [int(t) for t in args.suppress_tokens.split(",") if t.strip()]
    if args.temperature:
        kw["temperature"] = args.temperature
    for name in ("compression_ratio_threshold", "logprob_threshold", "no_speech_threshold"):
        v = getattr(args, name)
        if v is not _KEEP:
            kw[name] = v
    inc = args.temperature_increment_on_fallback
    if inc is _KEEP and args.temperature:
        # openai's CLI defaults the increment to 0.2, so `--temperature 0.4`
        # decodes with rungs (0.6, 0.8, 1.0), not the API's single decode
        inc = 0.2
    if inc is not _KEEP:
        try:
            kw["temperature_ladder"] = fallback_ladder(args.temperature, inc)
        except ValueError as e:
            raise SystemExit(f"--temperature-increment-on-fallback: {e}")
    if args.length_penalty is not None:
        kw["length_penalty"] = args.length_penalty
    if args.word_timestamps:
        kw["word_timestamps"] = True
    for name in ("prepend_punctuations", "append_punctuations"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    if args.hallucination_silence_threshold is not None:
        if not args.word_timestamps:
            raise SystemExit("--hallucination-silence-threshold requires --word-timestamps")
        kw["hallucination_silence_threshold"] = args.hallucination_silence_threshold
    if args.condition:
        kw["condition_on_previous_text"] = True
    if args.task != "transcribe":
        kw["task"] = args.task
    for name in ("initial_prompt", "prefix"):
        if getattr(args, name):
            kw[name] = getattr(args, name)
    if args.carry_initial_prompt:
        kw["carry_initial_prompt"] = True
    if args.without_timestamps:
        kw["without_timestamps"] = True
    if args.max_initial_timestamp is not None:
        kw["max_initial_timestamp"] = (
            None if args.max_initial_timestamp < 0 else args.max_initial_timestamp
        )
    return kw


def cmd_transcribe(args) -> None:
    kw = transcribe_kwargs(args)
    fmt = "json" if args.json else args.output_format
    if fmt == "all" and not args.output_dir:
        raise SystemExit("--output-format all requires --output-dir")
    if len(args.audio) > 1 and not args.output_dir:
        raise SystemExit("multiple audio inputs require --output-dir")

    from .pipeline import ingest
    from .utils import writers

    mesh = None
    if args.model_parallel:
        from .parallel import multihost

        multihost.initialize(device=args.device)
        mesh = kw["mesh"] = multihost.make_multihost_mesh(args.model_parallel, device=args.device)
    t = _make_transcriber(args, **kw)
    # every rank holds the same result; rank 0 writes it
    quiet = mesh is not None and (mesh.data_rank or mesh.model_rank)
    wopt = dict(  # openai's word-level subtitle options (srt/vtt only)
        highlight_words=args.highlight_words, max_line_width=args.max_line_width,
        max_line_count=args.max_line_count, max_words_per_line=args.max_words_per_line,
    )

    def render(out: dict, f: str) -> str:
        if f == "json":
            return json.dumps(out, indent=2) + "\n"
        return writers.format_segments(out["segments"], f, **(wopt if f in ("srt", "vtt") else {}))

    on_segment = None
    if args.verbose and not quiet:
        def on_segment(seg):  # openai's verbose timestamp form
            s = writers._timestamp(seg["start"], always_hours=True, decimal=".")
            e = writers._timestamp(seg["end"], always_hours=True, decimal=".")
            print(f"[{s} --> {e}] {seg['text']}", file=sys.stderr, flush=True)

    if args.output_dir and not quiet:
        os.makedirs(args.output_dir, exist_ok=True)
    used_stems: dict[str, int] = {}

    def emit(path: str, out: dict) -> None:
        if quiet:
            return
        if args.output_dir:
            # <output_dir>/<stem>.<fmt>; inputs with the same stem are numbered
            stem = os.path.splitext(os.path.basename(path))[0]
            n = used_stems.get(stem, 0)
            used_stems[stem] = n + 1
            if n:
                stem = f"{stem}.{n + 1}"
            targets = (("txt", "srt", "vtt", "tsv", "json") if fmt == "all"
                       else (("txt" if fmt == "text" else fmt),))
            for f in targets:
                with open(os.path.join(args.output_dir, f"{stem}.{f}"), "w",
                          encoding="utf-8") as fh:
                    fh.write(render(out, f))
            print(f"{path}: {out['duration']:.1f}s -> {args.output_dir}/{stem}."
                  f"{{{','.join(targets)}}} ({out['rtf_x']:.1f}x realtime)", file=sys.stderr)
        elif fmt in ("json", "srt", "vtt", "tsv", "txt"):
            print(render(out, fmt), end="")
            if fmt != "json":
                print(f"-- {out['duration']:.1f}s audio, {out['rtf_x']:.1f}x realtime",
                      file=sys.stderr)
        else:
            for seg in out["segments"]:
                print(f"[{seg['start']:8.2f} – {seg['end']:8.2f}] {seg['text']}")
            print(f"-- {out['duration']:.1f}s audio, {out['rtf_x']:.1f}x realtime",
                  file=sys.stderr)

    if len(args.audio) > 1 and not args.clip_timestamps:
        # several inputs and no clips: one shared-slab batch
        # (transcribe_batch), each file's result as transcribe gives it
        outs = t.transcribe_batch(
            list(args.audio), remove_silence=not args.keep_silence,
            on_segment=(
                (lambda fi, seg: on_segment(dict(seg, text=f"{args.audio[fi]}:{seg['text']}")))
                if on_segment is not None else None
            ),
        )
        for path, out in zip(args.audio, outs):
            emit(path, out)
    else:
        for path in args.audio:
            audio = ingest.load_audio(path)
            clips = None
            if args.clip_timestamps:
                from .utils.timestamps import parse_clip_timestamps

                clips = parse_clip_timestamps(args.clip_timestamps, len(audio) / ingest.TARGET_SR)
            emit(path, t.transcribe(audio, remove_silence=not args.keep_silence,
                                    clip_timestamps=clips, on_segment=on_segment))
    if mesh is not None:
        multihost.shutdown()


def cmd_stream(args) -> None:
    """Feed a file in --block-s blocks through StreamingTranscriber and
    print each segment as its window completes (--realtime paces the feed
    at 1x)."""
    import time

    from .pipeline import ingest
    from .pipeline.streaming import StreamingTranscriber

    if args.block_s <= 0:
        sys.exit(f"--block-s must be positive, got {args.block_s}")
    t = _make_transcriber(args, **_language_kw(args))
    st = StreamingTranscriber(t, partial_step_s=args.partial_step_s)
    audio = ingest.load_audio(args.audio)
    block = max(1, int(args.block_s * ingest.TARGET_SR))

    def emit(seg):
        print(f"[{seg['start']:8.2f} – {seg['end']:8.2f}] {seg['text']}", flush=True)

    for lo in range(0, len(audio), block):
        if args.realtime:
            time.sleep(args.block_s)
        for seg in st.feed(audio[lo : lo + block]):
            emit(seg)
    for seg in st.flush():
        emit(seg)


def cmd_detect_language(args) -> None:
    """openai's model.detect_language on the first 30 s of a file."""
    from .pipeline import ingest

    t = _make_transcriber(args)
    out = t.detect_language(ingest.load_audio(args.audio))
    if args.json:
        top = dict(list(out["probabilities"].items())[:10])
        print(json.dumps({"language": out["language"], "probabilities": top}, indent=2))
    else:
        print(out["language"])
        for code, prob in list(out["probabilities"].items())[:5]:
            print(f"  {code}: {prob:.3f}", file=sys.stderr)


def cmd_wer(args) -> None:
    from .utils.metrics import word_error_rate

    with open(args.reference) as f:
        ref = f.read()
    with open(args.hypothesis) as f:
        hyp = f.read()
    print(f"WER: {word_error_rate(ref, hyp):.4f}")


def cmd_der(args) -> None:
    """DER between two turn-list JSON files (the ``diarize --json`` shape),
    with the NIST miss / false-alarm / confusion split."""
    from .utils.metrics import diarization_error_rate_detailed

    with open(args.reference) as f:
        ref = json.load(f)
    with open(args.hypothesis) as f:
        hyp = json.load(f)
    d = diarization_error_rate_detailed(ref, hyp, collar_s=args.collar)
    print(
        f"DER: {d['der']:.4f} (miss {d['miss']:.4f}, false alarm "
        f"{d['false_alarm']:.4f}, confusion {d['confusion']:.4f}; "
        f"{d['hyp_speakers']} hyp vs {d['ref_speakers']} ref speakers)"
    )


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


def _model_args(p) -> None:
    p.add_argument("--model", default="tiny", help="preset for random weights")
    p.add_argument("--model-path", "--npz", dest="model_path",
                   help="checkpoint converted by the JAX package's convert tool")
    p.add_argument("--tokenizer", help="tokenizer asset overriding the embedded vocab")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="audio_processor_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("transcribe", help="transcribe audio files")
    t.add_argument("audio", nargs="+",
                   help="audio file(s); several inputs need --output-dir")
    t.add_argument("--output-dir", dest="output_dir",
                   help="write <stem>.<fmt> files here instead of stdout (openai's output_dir)")
    _model_args(t)
    t.add_argument("--model-parallel", dest="model_parallel", type=int, default=0,
                   help="serve on a (data, model) mesh over the ranks torchrun (or the "
                   "APTPU_* env) starts, heads split over this many ranks")
    t.add_argument("--keep-silence", action="store_true")
    t.add_argument("--verbose", action="store_true",
                   help="print segments to stderr as their windows are decoded "
                   "(openai's verbose=True)")
    t.add_argument("--json", action="store_true")
    t.add_argument("--language", help="ISO code (e.g. en, zh); default: auto-detect")
    t.add_argument("--beam", type=int, default=0, help="beam size (0 = greedy)")
    t.add_argument("--temperature", type=float, default=0.0,
                   help="decode temperature (0 = deterministic; > 0 samples from the "
                   "start); the retry ladder climbs from here in "
                   "--temperature-increment-on-fallback steps (default 0.2)")
    t.add_argument("--length-penalty", dest="length_penalty", type=float, default=None,
                   help="beam ranking exponent, Google-NMT form (default: average logprob)")
    t.add_argument("--temperature-increment-on-fallback",
                   dest="temperature_increment_on_fallback", type=_optional_float,
                   default=_KEEP, metavar="INC",
                   help="retry-ladder step from --temperature up to 1.0 (default 0.2; "
                   "'None' = a single decode)")
    t.add_argument("--compression-ratio-threshold", dest="compression_ratio_threshold",
                   type=_optional_float, default=_KEEP, metavar="R",
                   help="a decode whose text's zlib compression ratio exceeds this "
                   "failed (default 2.4; 'None' = off)")
    t.add_argument("--logprob-threshold", dest="logprob_threshold", type=_optional_float,
                   default=_KEEP, metavar="LP",
                   help="a decode whose average logprob is below this failed "
                   "(default -1.0; 'None' = off)")
    t.add_argument("--no-speech-threshold", dest="no_speech_threshold",
                   type=_optional_float, default=_KEEP, metavar="P",
                   help="a window is silent when P(<|nospeech|>) exceeds this and the "
                   "decode is unconfident (default 0.6; 'None' = off)")
    t.add_argument("--suppress-tokens", dest="suppress_tokens", default=None,
                   help="comma-separated token ids to suppress; '-1' = the default "
                   "non-speech set (openai's suppress_tokens)")
    t.add_argument("--patience", type=float, default=None,
                   help="beam patience (openai's patience; default 1.0)")
    t.add_argument("--best-of", dest="best_of", type=int, default=None,
                   help="sampling candidates on T>0 decodes (openai's best_of; default 5)")
    t.add_argument("--word-timestamps", action="store_true",
                   help="align each segment's words (openai's word_timestamps)")
    t.add_argument("--prepend-punctuations", dest="prepend_punctuations", default=None,
                   help="characters merged into the FOLLOWING word")
    t.add_argument("--append-punctuations", dest="append_punctuations", default=None,
                   help="characters merged into the PRECEDING word")
    t.add_argument("--highlight-words", dest="highlight_words", action="store_true",
                   help="srt/vtt: one cue a word, the word underlined (needs "
                   "--word-timestamps)")
    t.add_argument("--max-line-width", dest="max_line_width", type=int, default=None,
                   help="srt/vtt: characters a line (needs --word-timestamps)")
    t.add_argument("--max-line-count", dest="max_line_count", type=int, default=None,
                   help="srt/vtt: lines a cue (needs --word-timestamps)")
    t.add_argument("--max-words-per-line", dest="max_words_per_line", type=int, default=None,
                   help="srt/vtt: words a line (no effect with --max-line-width)")
    t.add_argument("--hallucination-silence-threshold", type=float, default=None,
                   dest="hallucination_silence_threshold", metavar="SECONDS",
                   help="drop anomalous segments next to silence longer than this "
                   "(needs --word-timestamps)")
    t.add_argument("--task", choices=("transcribe", "translate"), default="transcribe",
                   help="translate = X -> English (whisper's task token)")
    t.add_argument("--initial-prompt", dest="initial_prompt",
                   help="text context for the first window (openai's initial_prompt)")
    t.add_argument("--carry-initial-prompt", dest="carry_initial_prompt", action="store_true",
                   help="prompt EVERY window with --initial-prompt (openai's carry_initial_prompt)")
    t.add_argument("--prefix", help="text the decode continues from, left out of the output "
                   "(openai's DecodingOptions.prefix)")
    t.add_argument("--without-timestamps", dest="without_timestamps", action="store_true",
                   help="decode with <|notimestamps|>: each 30 s window is one segment")
    t.add_argument("--max-initial-timestamp", dest="max_initial_timestamp", type=float,
                   default=None, metavar="S",
                   help="cap on each window's first timestamp in seconds (default 1.0; "
                   "-1 = no cap)")
    t.add_argument("--output-format", dest="output_format",
                   choices=("text", "txt", "json", "srt", "vtt", "tsv", "all"), default="text",
                   help="output format (default: readable text on stdout; 'all' writes "
                   "every format and needs --output-dir)")
    t.add_argument("--clip-timestamps", dest="clip_timestamps",
                   help="comma-separated start,end second pairs to transcribe within; "
                   "a trailing lone start runs to the end")
    t.add_argument("--condition", action="store_true",
                   help="condition each window on the previous windows' text "
                   "(openai's condition_on_previous_text, in window groups)")
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

    s = sub.add_parser("stream", help="streaming transcription: segments print as windows "
                       "complete")
    s.add_argument("audio")
    _model_args(s)
    s.add_argument("--language", help="ISO code; default auto-detect")
    s.add_argument("--block-s", dest="block_s", type=float, default=1.0,
                   help="feed block size in seconds (default 1.0)")
    s.add_argument("--realtime", action="store_true", help="pace the feed at 1x")
    s.add_argument("--partial-step-s", dest="partial_step_s", type=float, default=0.0,
                   help="low-latency mode: re-decode the growing window every N seconds "
                   "and emit segments once two decodes agree (0 = at window completion)")
    s.set_defaults(fn=cmd_stream)

    dl = sub.add_parser("detect-language",
                        help="the spoken language of the first 30 s (openai's "
                        "model.detect_language)")
    dl.add_argument("audio")
    _model_args(dl)
    dl.add_argument("--json", action="store_true")
    dl.set_defaults(fn=cmd_detect_language)

    w = sub.add_parser("wer", help="word error rate between two text files")
    w.add_argument("reference")
    w.add_argument("hypothesis")
    w.set_defaults(fn=cmd_wer)

    de = sub.add_parser("der", help="diarization error rate between two turn-list JSON "
                        "files (the `diarize --json` shape; NIST collar protocol)")
    de.add_argument("reference")
    de.add_argument("hypothesis")
    de.add_argument("--collar", type=float, default=0.25,
                    help="seconds excluded around reference boundaries")
    de.set_defaults(fn=cmd_der)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
