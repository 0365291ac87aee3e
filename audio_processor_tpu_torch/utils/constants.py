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
