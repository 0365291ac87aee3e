"""Service container: wires engine + models + integrations for the server.

The port of the JAX package's ``runtime/services.py``: ``Services`` and
``build_services`` read the same ``APTPU_*`` environment into the same
fields of the port's ``Transcriber`` and ``Diarizer``, on the card unless
the caller passes ``device="cpu"``.  Under ``APTPU_DISTRIBUTED=1`` every
rank (one process each, e.g. started by ``torchrun``) joins the process
group and builds the same models on a (data, model) mesh of
``APTPU_MODEL_PARALLEL`` model ranks; rank 0 gets the job engine and
proxies of its models (``parallel/controller.py``), and the other ranks
get the controller to follow.  Without a multi-process environment it is
the one-process service.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any

from ..pipeline.meeting import MeetingProcessor, build_failure_result
from .job_engine import JobEngine

logger = logging.getLogger(__name__)


@dataclass
class Services:
    engine: JobEngine | None  # None on a mesh's follower ranks
    processor: MeetingProcessor
    credential_store: Any | None = None  # integrations.credentials.CredentialStore
    config: dict = field(default_factory=dict)
    # per-user OAuth Drive clients.  The reference keeps ONE global OAuth
    # service, so with two logged-in users the last login silently wins
    # (audio_processor.py:133-150 + the before_request restore); here each
    # user_id gets its own client.
    oauth_drives: dict = field(default_factory=dict)
    # parallel.controller.Controller under APTPU_DISTRIBUTED=1: rank 0's
    # models are its proxies; the other ranks run ``controller.follow()``
    controller: Any | None = None

    @property
    def oauth_drive(self):
        """Single-user compatibility accessor — STRICTLY the '__default__'
        client.  No sole-logged-in-user fallback: handing a context-free
        caller some real user's client would reintroduce exactly the
        cross-user credential leak drive_for exists to close."""
        return self.oauth_drives.get("__default__")

    @oauth_drive.setter
    def oauth_drive(self, client) -> None:
        if client is None:
            self.oauth_drives.clear()
        else:
            self.oauth_drives["__default__"] = client

    def drive_for(self, user_id: str | None):
        """This user's client; falls back ONLY to the explicit default —
        never to another user's client (no cross-user credential leakage)."""
        if user_id is not None and user_id in self.oauth_drives:
            return self.oauth_drives[user_id]
        return self.oauth_drives.get("__default__")

    def submit_processing_job(
        self,
        job_id: str,
        file_id: str,
        attachment_file_ids: list[str] | None,
        user_id: str | None,
    ) -> None:
        oauth_drive = self.drive_for(user_id)

        def run(ctx):
            return self.processor.process(
                ctx, file_id, attachment_file_ids, user_id, oauth_drive=oauth_drive
            )

        self.engine.submit(job_id, run, failure_result=build_failure_result)

    def submit_backlog_job(self, job_id: str, file_ids: list[str], user_id: str | None) -> None:
        """Several recordings as one job (``MeetingProcessor.process_backlog``):
        an on-card language model writes them up in batches."""
        oauth_drive = self.drive_for(user_id)

        def run(ctx):
            return self.processor.process_backlog(ctx, file_ids, user_id,
                                                  oauth_drive=oauth_drive)

        self.engine.submit(job_id, run, failure_result=build_failure_result)

    def set_oauth_credentials(self, creds, user_id: str | None = None) -> None:
        """Build a per-user Drive client from OAuth credentials
        (reference: audio_processor.py:133-150 — but per user, not global)."""
        from ..integrations.drive import DriveClient

        key = user_id or "__default__"
        self.oauth_drives[key] = DriveClient.from_google_credentials(creds)

    def clear_credentials(self, user_id: str | None = None) -> None:
        """Defined properly here — the reference calls a method that doesn't
        exist and swallows the AttributeError (auth_routes.py:698-701)."""
        if user_id is None:
            self.oauth_drives.clear()
        else:
            self.oauth_drives.pop(user_id, None)


def size_slabs(transcribers: list, decodes: int, reserved_bytes: int = 0) -> None:
    """Cap each Transcriber's slabs on its card (``card_slab_cap``) for
    ``decodes`` decodes at once, beside the others' weights and
    ``reserved_bytes`` more; on the CPU the caps stay."""
    weights = [t.weight_bytes() for t in transcribers]
    for t, w in zip(transcribers, weights):
        cap = t.card_slab_cap(decodes, reserved_bytes + sum(weights) - w)
        if cap is not None:
            t.max_chunk_batch = cap


def build_services(
    model: str = "tiny",
    store_url: str | None = None,
    max_workers: int = 3,
    with_drive: bool = True,
    with_llm: bool = True,
    diarization: bool = True,
    model_path: str | None = None,
    device=None,
) -> Services:
    """Assemble a full service stack from environment configuration, on
    ``device`` (None: the card; raises without one unless "cpu").

    External clients degrade to None when unconfigured so the pipeline runs
    standalone (local files, no LLM/Notion) — the hermetic-test and
    air-gapped mode the reference lacks.
    """
    from ..pipeline.transcribe import Transcriber
    from .device_check import probe_device

    # multi-process serving: join the process group (torchrun's or the
    # APTPU_* topology) before the first device op, then lay the (data,
    # model) mesh out with each model group on one host.  Only rank 0 runs
    # a job engine (the controller below), so no rank can take another's
    # job and a shared store is not needed: JAX's redis warning has no
    # counterpart here.
    mesh = None
    if os.environ.get("APTPU_DISTRIBUTED") == "1":
        from ..parallel import multihost

        if multihost.initialize(device=None if device is None else str(device)):
            mesh = multihost.make_multihost_mesh(
                int(os.environ.get("APTPU_MODEL_PARALLEL") or 1), device=device)
            logger.info("multi-host mesh: %s", mesh.shape)

    # Fail fast if the card does not answer — otherwise the first device op
    # below (param init / checkpoint load) may hang with no log line
    # (APTPU_DEVICE_INIT_TIMEOUT_S tunes/disables).
    probe_device(device=device)

    # A configured-but-missing checkpoint is a deployment error (e.g. the
    # model volume was not mounted): refuse to start rather than silently
    # serve random-weight garbage transcripts as "completed" jobs.
    # decode options from the environment — the knobs whisper.transcribe
    # exposes per call, pinned service-wide here (the reference hardcodes
    # its engine defaults at app/services/audio_processor.py:1076)
    tkw: dict = {}
    if os.environ.get("APTPU_BEAM_SIZE"):
        tkw["beam_size"] = int(os.environ["APTPU_BEAM_SIZE"])
    if os.environ.get("APTPU_BEST_OF"):
        tkw["best_of"] = int(os.environ["APTPU_BEST_OF"])
    if os.environ.get("APTPU_PATIENCE"):
        tkw["patience"] = float(os.environ["APTPU_PATIENCE"])
    if os.environ.get("APTPU_TEMPERATURE"):
        tkw["temperature"] = float(os.environ["APTPU_TEMPERATURE"])
    if os.environ.get("APTPU_LENGTH_PENALTY"):
        tkw["length_penalty"] = float(os.environ["APTPU_LENGTH_PENALTY"])
    # quality-gate thresholds — the literal string "None" disables a
    # check, exactly as openai's optional_float CLI form
    from ..utils.options import optional_float

    for env, field in (
        ("APTPU_COMPRESSION_RATIO_THRESHOLD", "compression_ratio_threshold"),
        ("APTPU_LOGPROB_THRESHOLD", "logprob_threshold"),
        ("APTPU_NO_SPEECH_THRESHOLD", "no_speech_threshold"),
    ):
        raw = os.environ.get(env)
        if raw:
            tkw[field] = optional_float(raw)
    if os.environ.get("APTPU_INITIAL_PROMPT"):
        tkw["initial_prompt"] = os.environ["APTPU_INITIAL_PROMPT"]
    if os.environ.get("APTPU_CARRY_INITIAL_PROMPT") == "1":
        tkw["carry_initial_prompt"] = True
    if os.environ.get("APTPU_PREFIX"):
        tkw["prefix"] = os.environ["APTPU_PREFIX"]
    if os.environ.get("APTPU_WITHOUT_TIMESTAMPS") == "1":
        tkw["without_timestamps"] = True
    if os.environ.get("APTPU_MAX_INITIAL_TIMESTAMP"):
        v = float(os.environ["APTPU_MAX_INITIAL_TIMESTAMP"])
        tkw["max_initial_timestamp"] = None if v < 0 else v
    if os.environ.get("APTPU_CONDITION") == "1":
        tkw["condition_on_previous_text"] = True
    if os.environ.get("APTPU_WORD_TIMESTAMPS") == "1":
        tkw["word_timestamps"] = True
    if os.environ.get("APTPU_HALLUCINATION_SILENCE_S"):
        tkw["word_timestamps"] = True
        tkw["hallucination_silence_threshold"] = float(
            os.environ["APTPU_HALLUCINATION_SILENCE_S"]
        )
    if os.environ.get("APTPU_LANGUAGE"):
        from ..models.whisper.tokenizer import language_index

        tkw["language"] = language_index(
            os.environ["APTPU_LANGUAGE"], num_languages=None
        )
    if os.environ.get("APTPU_TASK"):
        tkw["task"] = os.environ["APTPU_TASK"]

    if model_path:
        if not os.path.exists(model_path):
            raise FileNotFoundError(
                f"model_path / APTPU_MODEL_PATH is set to {model_path!r} but "
                "no such file exists — refusing to fall back to random "
                "weights (is the model volume mounted?)"
            )
        transcriber = Transcriber.from_npz(model_path, device=device, mesh=mesh, **tkw)
    else:
        logger.warning(
            "no Whisper checkpoint configured (APTPU_MODEL_PATH unset) — "
            "serving RANDOM weights; transcripts will be garbage. "
            "Test/bench mode only."
        )
        transcriber = Transcriber.random_init(model, device=device, mesh=mesh, **tkw)

    # smaller-model retry target (the reference's medium->small fallback,
    # audio_processor.py:1056-1098): jobs whose primary decode raises are
    # retried once on this transcriber before failing
    fallback = None
    fb_path = os.environ.get("APTPU_FALLBACK_MODEL_PATH")
    fb_model = os.environ.get("APTPU_FALLBACK_MODEL")
    if fb_path:
        if not os.path.exists(fb_path):
            raise FileNotFoundError(
                f"APTPU_FALLBACK_MODEL_PATH is set to {fb_path!r} but no "
                "such file exists — refusing to fall back to random weights"
            )
        fallback = Transcriber.from_npz(fb_path, device=device, mesh=mesh, **tkw)
    elif fb_model:
        fallback = Transcriber.random_init(fb_model, device=device, mesh=mesh, **tkw)

    # The slabs are sized for the decodes that can run at once on the card:
    # the /v1 decode slots and the job engine's workers (a job's decode
    # takes no slot), beside the other Transcriber's weights and a local
    # language model's peak.  On a mesh every rank sizes them alike.
    from ..server.openai_api import decode_slots

    reserved = 0
    llm = os.environ.get("APTPU_LOCAL_LLM") if with_llm else None
    if llm:
        from ..integrations.local_llm import LocalLLMClient

        reserved = LocalLLMClient.card_bytes(llm)
    size_slabs([t for t in (transcriber, fallback) if t is not None],
               decode_slots() + max_workers, reserved)

    # APTPU_WARMUP=<n_chunks>: build and load the kernels and run one decode
    # at startup instead of on the first request's thread.  The value is
    # the number of 30 s windows to warm (1 = a 30 min recording,
    # ``WARMUP_WINDOWS``); 0/unset = off.  On a mesh every rank runs it
    # here, together.
    warmup_raw = os.environ.get("APTPU_WARMUP", "0")
    if warmup_raw not in ("", "0"):
        transcriber.warmup(None if warmup_raw == "1" else int(warmup_raw))

    diarizer = None
    if diarization:
        from ..pipeline.diarize import Diarizer

        diar_path = os.environ.get("APTPU_DIARIZER_PATH")
        # trained speaker-embedding checkpoint (cli train-embedding) —
        # composes with either segmentation source below
        emb_kw: dict = {"device": device, "mesh": mesh}
        emb_path = os.environ.get("APTPU_EMBEDDING_PATH")
        if emb_path:
            if not os.path.exists(emb_path):
                raise FileNotFoundError(
                    f"APTPU_EMBEDDING_PATH is set to {emb_path!r} but no such "
                    "file exists — refusing to fall back to random weights"
                )
            from ..models.diarization import checkpoint, embedding

            tree, emb_cfg = checkpoint.load_embedding_params(emb_path)
            emb_kw.update(emb_params=embedding.params_from_jax(tree, emb_cfg), emb_cfg=emb_cfg)
        if diar_path:
            if not os.path.exists(diar_path):
                raise FileNotFoundError(
                    f"APTPU_DIARIZER_PATH is set to {diar_path!r} but no such "
                    "file exists — refusing to fall back to random weights"
                )
            import numpy as np

            with np.load(diar_path) as d:
                is_tpu_seg = "cfg.window_s" in d.files
            # converted pyannote+ResNet pack vs a trained TPU-native
            # segmentation checkpoint (cli train-segmentation output)
            diarizer = (
                Diarizer.from_tpu_segmentation(diar_path, **emb_kw)
                if is_tpu_seg
                else Diarizer.from_npz(diar_path, **emb_kw)
            )
        else:
            # in-repo synthetic-pretrained default before random weights:
            # working speaker separation out of the box, marked with
            # provenance "bundled-synthetic" in job results (round-2
            # review: serving random diarizer weights should be loud)
            diarizer = Diarizer.bundled(**emb_kw)
            if diarizer is not None:
                logger.warning(
                    "no diarization checkpoint configured (APTPU_DIARIZER_"
                    "PATH unset) — serving the BUNDLED synthetic-pretrained "
                    "diarizer (not pyannote parity; set APTPU_DIARIZER_PATH "
                    "for production weights)"
                )
            else:
                logger.warning(
                    "no diarization checkpoint configured (APTPU_DIARIZER_PATH "
                    "unset) — serving a RANDOM segmentation net%s",
                    " (embedding net is the trained APTPU_EMBEDDING_PATH "
                    "checkpoint)" if emb_path else " and RANDOM embedding weights",
                )
                diarizer = Diarizer.random_init(**emb_kw)
        # speaker-count constraints (pyannote's num/min/max_speakers)
        num_spk = os.environ.get("APTPU_NUM_SPEAKERS")
        if num_spk:
            diarizer.min_speakers = diarizer.max_speakers = int(num_spk)
        else:
            if os.environ.get("APTPU_MIN_SPEAKERS"):
                diarizer.min_speakers = int(os.environ["APTPU_MIN_SPEAKERS"])
            if os.environ.get("APTPU_MAX_SPEAKERS"):
                diarizer.max_speakers = int(os.environ["APTPU_MAX_SPEAKERS"])

    controller = None
    if mesh is not None:
        from ..parallel.controller import Controller

        controller = Controller(mesh, {"primary": transcriber, "fallback": fallback,
                                       "diarizer": diarizer})
        if not controller.is_leader:  # a follower: no engine, no HTTP, no clients
            return Services(
                engine=None,
                processor=MeetingProcessor(transcriber=transcriber, diarizer=diarizer,
                                           fallback_transcriber=fallback),
                controller=controller,
            )
        transcriber = controller.proxy("primary")
        fallback = controller.proxy("fallback")
        diarizer = controller.proxy("diarizer")

    drive = None
    if with_drive:
        try:
            from ..integrations.drive import DriveClient

            drive = DriveClient.from_service_account_file()
        except Exception as exc:  # noqa: BLE001 — optional dependency
            logger.info("no service-account Drive client: %s", exc)

    gemini = None
    notion = None
    if with_llm:
        from ..integrations.gemini import GeminiClient
        from ..integrations.notion import NotionClient

        # APTPU_LOCAL_LLM=<preset> (models/llm/config.py: deepseek-v2-lite,
        # or kimi-linear-48b-a3b, whose one card holds half of each layer's
        # experts): the speaker, summary and notes stages run on this
        # process's device instead of Gemini's API
        local = os.environ.get("APTPU_LOCAL_LLM")
        if local:
            from ..integrations.local_llm import LocalLLMClient

            logger.warning(
                "APTPU_LOCAL_LLM=%s: no checkpoint or tokenizer ships with the port — "
                "serving RANDOM language-model weights and a byte tokenizer; speaker "
                "names, summaries and notes will be noise. Test/bench mode only.", local)
            gemini = LocalLLMClient.random_init(local, device=device)
        else:
            g = GeminiClient()
            gemini = g if g.available else None
        n = NotionClient()
        notion = n if n.available else None

    credential_store = None
    try:
        from ..integrations.credentials import CredentialStore

        credential_store = CredentialStore()
    except Exception as exc:  # noqa: BLE001
        logger.info("credential store unavailable: %s", exc)

    engine = JobEngine(max_workers=max_workers, store_url=store_url)
    if store_url and not store_url.startswith("memory"):
        engine.recover_orphans()  # persistent store: finalise jobs a dead
        # process left in flight (the reference silently loses them)
        # server-side retention (the reference only prunes its frontend's
        # localStorage copy, app.js:42-164 — the server grows forever)
        engine.prune_old_jobs(
            float(os.environ.get("APTPU_JOB_RETENTION_DAYS", "30"))
        )
    # Drive capability is a DEPLOYMENT property: a service account OR an
    # OAuth login config means Drive users exist, so server-local file_id
    # paths stay refused even for anonymous callers (who have no per-job
    # Drive client — the old per-job check let exactly them through)
    from ..server.auth import load_client_config

    drive_capable = drive is not None or load_client_config() is not None
    processor = MeetingProcessor(
        transcriber=transcriber,
        diarizer=diarizer,
        drive=drive,
        gemini=gemini,
        notion=notion,
        fallback_transcriber=fallback,
        drive_capable=drive_capable,
    )
    return Services(
        engine=engine, processor=processor, credential_store=credential_store,
        controller=controller,
    )
