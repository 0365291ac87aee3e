"""Job lifecycle constants (reference: app/utils/constants.py:2-9).

Same status vocabulary so job JSON stays byte-compatible.  The reference
also defines QUEUED but never uses it (SURVEY.md appendix) — kept here for
API compatibility, and actually used: jobs wait as 'queued' when the worker
pool is saturated.

A copy of the JAX package's ``utils/constants.py``: the PyTorch package
imports nothing of that package.
"""

JOB_STATUS = {
    "QUEUED": "queued",
    "PENDING": "pending",
    "PROCESSING": "processing",
    "COMPLETED": "completed",
    "FAILED": "failed",
    "CANCELLED": "cancelled",
}

# Per-stage progress checkpoints, matching the reference pipeline's
# _update_job_progress call sites (audio_processor.py:1223-1344).
PROGRESS = {
    "start": 5,
    "attachments": 8,
    "download": 15,
    "preprocess": 25,
    "convert": 30,
    "transcribe": 65,
    "identify_speakers": 75,
    "summary": 80,
    "notion": 90,
    "rename": 95,
    "done": 100,
}

# The work of the job stage that starts at each checkpoint.  A stage's span
# is job.<name> (JobContext.stage), so stage_timings and the
# aptpu_stage_seconds_mean labels name the work and not the checkpoint
# (the stage at PROGRESS["convert"] transcribes, diarizes and fuses).
STAGES = {
    PROGRESS["start"]: "metadata",
    PROGRESS["attachments"]: "attachments",
    PROGRESS["download"]: "download",
    PROGRESS["preprocess"]: "decode_audio",
    PROGRESS["convert"]: "transcribe",
    PROGRESS["transcribe"]: "speakers",
    PROGRESS["identify_speakers"]: "transcript",
    PROGRESS["summary"]: "summary",
    PROGRESS["notion"]: "notion",
    PROGRESS["rename"]: "rename",
}
