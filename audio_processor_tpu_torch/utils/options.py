"""Shared option-string parsing for the CLI and the APTPU_* service env.

openai-whisper's CLI uses ``optional_float``: the literal string "None"
disables a threshold entirely (whisper/transcribe.py's cli() helper
``optional_float``); the reference inherits those semantics through
``whisper_model.transcribe`` (reference: app/services/audio_processor.py:1076).
Both of this repo's config surfaces (cli.py flags, runtime/services.py env
knobs) parse through here so the convention cannot drift.

A copy of the JAX package's ``utils/options.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations


def optional_float(s: str) -> float | None:
    """Parse a float, with the literal "none"/"None" meaning disabled."""
    return None if s.strip().lower() == "none" else float(s)


def fallback_ladder(
    temperature: float, increment: float | None
) -> tuple[float, ...]:
    """openai's rung list: ``np.arange(temperature, 1.0 + 1e-6, increment)``
    (whisper.transcribe's temperature_increment_on_fallback), minus the
    base itself; ``increment=None`` means a single decode, no retries.

    Raises ValueError on a non-positive increment (np.arange would raise
    on 0 and return empty on negative — either way no ladder exists).
    """
    if increment is None:
        return ()
    if increment <= 0:
        raise ValueError(
            f"temperature increment must be > 0, got {increment}"
        )
    base, ladder = temperature, []
    while base + increment <= 1.0 + 1e-6:
        base += increment
        ladder.append(round(base, 10))
    return tuple(ladder)
