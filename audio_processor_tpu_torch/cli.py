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

    python -m audio_processor_tpu_torch.cli convert-whisper small.pt small.npz \
        --tokenizer multilingual.tiktoken      # or an HF checkpoint directory
    python -m audio_processor_tpu_torch.cli convert-diarizer seg.ckpt emb.pt diarizer.npz
    python -m audio_processor_tpu_torch.cli finetune-whisper manifest.jsonl \
        --model-path small.npz --out tuned.npz
    python -m audio_processor_tpu_torch.cli train-segmentation --out seg.npz
    python -m audio_processor_tpu_torch.cli train-embedding --out emb.npz
    python -m audio_processor_tpu_torch.cli calibrate-alignment-heads tuned.npz speech.wav --write

``transcribe`` takes the JAX package's flags (openai-whisper's CLI
options).  Without --model-path (--npz) the weights are random (seeded):
the flow runs end to end, the text is meaningless.  ``diarize`` serves the
repo's bundled synthetic-pretrained nets (random weights when they are
absent).  ``process`` runs the full 9-stage meeting job on a local file,
with no Drive, LLM or Notion, and prints the job's status as JSON.
The converters are host work (numpy, and ``torch.load`` for ``.pt``
files); the trainers and the calibration run on --device.
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
        if f == "json":  # openai's result; the stage trace is the service's
            return json.dumps({k: v for k, v in out.items() if k != "trace"}, indent=2) + "\n"
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


def cmd_convert_whisper(args) -> None:
    from .models.whisper import convert
    from .models.whisper.tokenizer import load_tokenizer_file

    if os.path.isdir(args.checkpoint):
        # a HF checkpoint directory: safetensors + json, the vocab embedded
        # from its vocab.json/merges.txt
        params, cfg, tokenizer = convert.load_hf_checkpoint(args.checkpoint)
    else:
        params, cfg = convert.load_openai_checkpoint(args.checkpoint)
        tokenizer = None
    if args.tokenizer:
        tokenizer = load_tokenizer_file(args.tokenizer)
    if tokenizer is None:
        print(
            "WARNING: no tokenizer found/given — the .npz will have no "
            "embedded vocab and serving will fall back to the byte "
            "tokenizer (garbage text on real weights).  Pass the "
            "checkpoint's multilingual.tiktoken / gpt2.tiktoken (or HF "
            "vocab.json) via --tokenizer.",
            file=sys.stderr,
        )
    convert.save_params(args.out, params, cfg, tokenizer=tokenizer)
    print(f"converted {args.checkpoint} -> {args.out} ({cfg.n_audio_state}d, "
          f"{cfg.n_audio_layer}+{cfg.n_text_layer} layers"
          f"{', vocab embedded' if tokenizer else ''})")


def cmd_convert_diarizer(args) -> None:
    """pyannote segmentation + ResNet embedding checkpoints -> one .npz.
    The files are unpickled (``weights_only=False``): convert only
    checkpoints you trust."""
    import torch

    from .models.diarization import convert as dconvert

    def state_dict(path):
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return sd

    seg_params, _ = dconvert.from_pyannet_state_dict(state_dict(args.segmentation))
    emb_params, _ = dconvert.from_resnet_state_dict(state_dict(args.embedding))
    dconvert.save_diarizer_params(args.out, seg_params, emb_params)
    print(f"converted -> {args.out}")


def _window_log_mels(audios: list, n_samples: int, n_mels: int, device) -> "np.ndarray":
    """Each recording's first n_samples, zero-padded, -> log-mel (N, n_mels,
    n_samples // 160) as float32 numpy.  The windows are stacked and go
    through ``log_mel`` (kernel A on the card) up to 128 at a launch."""
    import numpy as np
    import torch

    from .ops.kernels.log_mel import log_mel

    stack = np.zeros((len(audios), n_samples), np.float32)
    for i, audio in enumerate(audios):
        piece = audio[:n_samples]
        stack[i, : len(piece)] = piece
    out = []
    for lo in range(0, len(stack), 128):
        x = torch.from_numpy(stack[lo : lo + 128]).to(device)
        out.append(log_mel(x, n_mels).cpu().numpy())
    return np.concatenate(out)


def cmd_finetune_whisper(args) -> None:
    """Fine-tune Whisper on a manifest of (audio, transcript) pairs: one
    JSON object a line, {"audio": "path.wav", "text": "..."}.  One process;
    the sharded dp x tp step is ``training/train_step`` under a mesh."""
    import numpy as np
    import torch

    from .models.whisper import convert, decode as decode_lib, model as model_lib
    from .models.whisper.config import get_config
    from .models.whisper.tokenizer import ByteTokenizer, language_index, load_tokenizer_file
    from .ops import frontend
    from .pipeline import ingest
    from .runtime.device import resolve_device
    from .training import train_step as ts

    items = []
    with open(args.manifest) as fh:
        for line in fh:
            if line.strip():
                items.append(json.loads(line))
    if not items:
        raise SystemExit("empty manifest")

    device = resolve_device(args.device)
    if args.model_path:
        params, cfg = convert.load_params(args.model_path, device)
    else:
        cfg = get_config(args.model)
        params = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    st = decode_lib.SpecialTokens.for_config(cfg)
    # the training text is tokenized with the checkpoint's vocab: --tokenizer
    # > the vocab embedded in the .npz > ByteTokenizer (random weights only)
    if args.tokenizer:
        tokenizer = load_tokenizer_file(args.tokenizer)
    elif args.model_path:
        tokenizer = convert.load_tokenizer(args.model_path)
        if tokenizer is None:
            raise SystemExit(
                f"{args.model_path} has no embedded tokenizer — pass "
                "--tokenizer, or re-convert with convert-whisper --tokenizer. "
                "Refusing to fine-tune real weights against byte ids."
            )
    else:
        tokenizer = ByteTokenizer()
    lang = language_index(args.language, num_languages=None) if args.language else None
    sot_seq = st.sot_sequence(language=lang, timestamps=False)

    # the dataset: 30 s log-mel windows + teacher-forced token rows
    n_samples = 2 * cfg.n_audio_ctx * frontend.HOP_LENGTH
    max_t = args.max_tokens
    if max_t < len(sot_seq) + 2:
        raise SystemExit(
            f"--max-tokens {max_t} cannot hold the {len(sot_seq)}-token sot "
            "sequence plus at least one text token and <|eot|>"
        )
    mels = _window_log_mels([ingest.load_audio(it["audio"]) for it in items],
                           n_samples, cfg.n_mels, device)
    tins, touts, masks = [], [], []
    for it in items:
        toks = [int(t) for t in tokenizer.encode(" " + it["text"].strip()) if int(t) < st.eot]
        seq = list(sot_seq) + toks[: max_t - len(sot_seq) - 1] + [st.eot]
        ti = np.full(max_t, st.eot, np.int64)
        to = np.full(max_t, st.eot, np.int64)
        mk = np.zeros(max_t, np.float32)
        ti[: len(seq) - 1] = seq[:-1]
        to[: len(seq) - 1] = seq[1:]
        # loss on the text and <|eot|>, not on predicting the sot prefix
        mk[len(sot_seq) - 1 : len(seq) - 1] = 1.0
        tins.append(ti)
        touts.append(to)
        masks.append(mk)
    tins, touts, masks = np.stack(tins), np.stack(touts), np.stack(masks)

    state = ts.TrainState(params, ts.make_optimizer(args.lr).init(ts.tree_leaves(params)), 0)
    rng = np.random.default_rng(args.seed)
    first_loss = last_loss = None
    for step in range(args.steps):
        idx = rng.integers(0, len(items), args.batch)
        batch = ts.Batch(*(torch.from_numpy(a[idx]).to(device) for a in (mels, tins, touts, masks)))
        state, loss = ts.train_step(state, cfg, batch, lr=args.lr)
        last_loss = float(loss)
        if first_loss is None:
            first_loss = last_loss
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {last_loss:.4f}", file=sys.stderr)
    if first_loss is not None:
        print(f"loss {first_loss:.4f} -> {last_loss:.4f} over {args.steps} steps")
    else:
        print(f"no training steps ran (--steps {args.steps})", file=sys.stderr)
    if args.out:
        convert.save_params(
            args.out, state.params, cfg,
            tokenizer=None if isinstance(tokenizer, ByteTokenizer) else tokenizer,
        )
        print(f"saved {args.out} (serve with `transcribe --model-path {args.out}`)")


def cmd_train_segmentation(args) -> None:
    """Train the TPU-first segmentation net with the powerset loss, on
    synthetic mixtures (hermetic training and calibration)."""
    import numpy as np
    import torch

    from .models.diarization import segmentation_tpu as seg
    from .models.diarization.segmentation import powerset_matrix
    from .runtime.device import resolve_device
    from .training import diarization_trainer as dt

    device = resolve_device(args.device)
    cfg = seg.TpuSegmentationConfig(window_s=args.window_s)
    member = powerset_matrix(cfg)
    lut = dt.powerset_lookup(member)
    member_t, lut_t = torch.from_numpy(member).to(device), torch.from_numpy(lut).to(device)
    rng = np.random.default_rng(args.seed)
    state = dt.init_train_state(cfg, torch.Generator(device=device).manual_seed(args.seed),
                                lr=args.lr)
    for step in range(args.steps):
        xs, ys = zip(*(dt.synth_mixture(rng, cfg) for _ in range(args.batch)))
        state, loss = dt.train_step(
            state, cfg, torch.from_numpy(np.stack(xs)).to(device),
            torch.from_numpy(np.stack(ys)).to(device), member_t, lut_t, lr=args.lr,
        )
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:4d}  powerset loss {float(loss):.4f}")
    if args.out:
        dt.save_params(args.out, state.params, cfg)
        print(f"saved trained segmentation -> {args.out} "
              f"(serve with `diarize --segmentation-path {args.out}` or "
              f"Diarizer.from_tpu_segmentation)")


def cmd_train_embedding(args) -> None:
    """Train the speaker-embedding net with AAM-softmax on synthetic
    speakers; the trained cosine space is what AHC clusters on."""
    import numpy as np
    import torch

    from .models.diarization import embedding as emb
    from .runtime.device import resolve_device
    from .training import embedding_trainer as et

    device = resolve_device(args.device)
    cfg = emb.EmbeddingConfig(crop_s=args.crop_s)
    rng = np.random.default_rng(args.seed)
    f0s = tuple(90.0 * (1.45 ** i) for i in range(args.speakers))
    state = et.init_train_state(cfg, args.speakers,
                                torch.Generator(device=device).manual_seed(args.seed), lr=args.lr)
    for step in range(args.steps):
        labels = rng.integers(0, args.speakers, args.batch)
        crops = np.stack([et.synth_speaker_crop(rng, f0s[s], cfg) for s in labels])
        state, loss = et.train_step(state, cfg, torch.from_numpy(crops).to(device),
                                    torch.from_numpy(labels).to(device), lr=args.lr)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:4d}  aam loss {float(loss):.4f}")
    if args.out:
        et.save_params(args.out, state.params, cfg)
        print(f"saved trained embedding -> {args.out} "
              f"(serve with `diarize --embedding-path {args.out}`)")


def cmd_calibrate_alignment_heads(args) -> None:
    """Measure a word-timestamp alignment-head mask for a checkpoint: decode
    one recording, score every cross-attention head by the mass it puts on
    its own monotonic DTW path, print the winners and (with --write) store
    them in the .npz, keeping its embedded vocab."""
    import dataclasses

    from .models.whisper import align, convert
    from .pipeline import ingest
    from .pipeline.transcribe import Transcriber

    # weights_dtype=None: --write re-saves the .npz, and the default
    # compute-dtype cast would round the stored f32 weights to bf16
    t = Transcriber.from_npz(args.checkpoint, weights_dtype=None, device=args.device)
    audio = ingest.load_audio(args.audio)
    states = t._frontend_encode(t._chunk_slab(audio, [0], 1))
    result = t._run_decode(states)
    tokens = result.tokens[:1].cpu().numpy()
    # calibrate under the sot prefix serving aligns with
    lang = t._active_language if t._active_language is not None else t.language
    pairs = align.calibrate_alignment_heads(
        t.params, t.cfg, states[:1], tokens, t.special, top_k=args.top_k,
        sot_sequence=t._sot_seq(lang),
    )
    print(json.dumps({"alignment_heads": [list(p) for p in pairs]}))
    if args.write:
        cfg2 = dataclasses.replace(t.cfg, alignment_heads=pairs)
        # read the embedded vocab before savez rewrites the file
        embedded = convert.load_tokenizer(args.checkpoint)
        convert.save_params(args.checkpoint, t.params, cfg2, tokenizer=embedded)
        print(f"wrote alignment heads into {args.checkpoint}", file=sys.stderr)


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

    c = sub.add_parser("convert-whisper",
                       help="openai .pt OR HF checkpoint dir (torch-free) -> native .npz")
    c.add_argument("checkpoint", help="openai .pt file, or a HF Whisper checkpoint directory "
                   "(config.json + model.safetensors; read without torch)")
    c.add_argument("out")
    c.add_argument("--tokenizer", help="embed this vocab (multilingual/gpt2.tiktoken or HF "
                   "vocab.json) into the .npz so serving needs no separate asset")
    c.set_defaults(fn=cmd_convert_whisper)

    cd = sub.add_parser("convert-diarizer", help="pyannote+ResNet ckpts -> .npz")
    cd.add_argument("segmentation", help="pyannote PyanNet checkpoint (.ckpt/.pt)")
    cd.add_argument("embedding", help="ResNet34 embedding checkpoint (.pt)")
    cd.add_argument("out")
    cd.set_defaults(fn=cmd_convert_diarizer)

    ft = sub.add_parser("finetune-whisper",
                        help="fine-tune Whisper on a jsonl manifest of {audio, text} pairs")
    ft.add_argument("manifest", help="jsonl: {\"audio\": path, \"text\": str}")
    ft.add_argument("--model", default="tiny")
    ft.add_argument("--model-path", dest="model_path", help="start from a converted .npz")
    ft.add_argument("--tokenizer", help="tokenizer asset for the training text (default: "
                    "the checkpoint's embedded vocab)")
    ft.add_argument("--language", help="ISO code pinned into the sot sequence")
    ft.add_argument("--steps", type=int, default=200)
    ft.add_argument("--batch", type=int, default=8)
    ft.add_argument("--lr", type=float, default=1e-4)
    ft.add_argument("--max-tokens", type=int, default=128, dest="max_tokens")
    ft.add_argument("--seed", type=int, default=0)
    ft.add_argument("--out", help="save fine-tuned params to this .npz")
    ft.add_argument("--device", default=None, help="cuda (default) or cpu")
    ft.set_defaults(fn=cmd_finetune_whisper)

    ts = sub.add_parser("train-segmentation",
                        help="train the TPU-first segmentation net (powerset loss)")
    ts.add_argument("--steps", type=int, default=100)
    ts.add_argument("--batch", type=int, default=8)
    ts.add_argument("--lr", type=float, default=1e-3)
    ts.add_argument("--window-s", type=float, default=10.0, dest="window_s")
    ts.add_argument("--seed", type=int, default=0)
    ts.add_argument("--out", help="save trained params to this .npz")
    ts.add_argument("--device", default=None, help="cuda (default) or cpu")
    ts.set_defaults(fn=cmd_train_segmentation)

    te = sub.add_parser("train-embedding",
                        help="train the speaker-embedding net (AAM-softmax, synthetic speakers)")
    te.add_argument("--steps", type=int, default=100)
    te.add_argument("--batch", type=int, default=16)
    te.add_argument("--lr", type=float, default=1e-3)
    te.add_argument("--speakers", type=int, default=8)
    te.add_argument("--crop-s", type=float, default=3.0, dest="crop_s")
    te.add_argument("--seed", type=int, default=0)
    te.add_argument("--out", help="save trained params to this .npz")
    te.add_argument("--device", default=None, help="cuda (default) or cpu")
    te.set_defaults(fn=cmd_train_embedding)

    ch = sub.add_parser("calibrate-alignment-heads",
                        help="measure + store a word-timestamp head mask for a checkpoint")
    ch.add_argument("checkpoint", help="converted .npz checkpoint")
    ch.add_argument("audio", help="calibration recording (speech)")
    ch.add_argument("--top-k", type=int, default=6, dest="top_k")
    ch.add_argument("--write", action="store_true",
                    help="store the mask into the checkpoint's sidecar")
    ch.add_argument("--device", default=None, help="cuda (default) or cpu")
    ch.set_defaults(fn=cmd_calibrate_alignment_heads)

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
