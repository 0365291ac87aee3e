"""Google Gemini client with the model-fallback ladder, plus the three LLM
tasks: speaker identification, summary/title/todos, full meeting notes.

The reference calls google-generativeai with a 6-model ladder that skips to
the next model on quota errors (reference:
app/services/audio_processor.py:423-476) and wraps three prompt tasks
around it (:932-976, :978-1030, :478-502).  That SDK isn't in this image,
so this is a first-party REST client for the generativelanguage v1beta API
with the same ladder semantics, plus hardening the reference lacks:
  * JSON extraction that parses balanced objects instead of the reference's
    non-greedy regex `({.*?})` (which truncates nested JSON);
  * speaker-identification samples spread over the WHOLE meeting instead of
    the first 20 segments (reference defect, SURVEY.md appendix);
  * injectable transport for hermetic tests.

A copy of the JAX package's ``integrations/gemini.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Callable

logger = logging.getLogger(__name__)

# the reference's ladder order (audio_processor.py:440-441), kept for
# documentation/parity.  Its first two entries are RETIRED preview
# endpoints — the 404-skip below survives them, but every call would pay
# two dead round trips first, so the serving default reorders live models
# ahead of the retired ids (GEMINI_MODELS env overrides entirely).
REFERENCE_MODELS = (
    "gemini-2.5-pro-exp-03-25",
    "gemini-2.5-flash-preview-04-17",
    "gemini-1.5-pro",
    "gemini-2.0-flash",
    "gemini-1.5-flash",
    "gemini-2.0-flash-lite",
)
DEFAULT_MODELS = (
    "gemini-1.5-pro",
    "gemini-2.0-flash",
    "gemini-1.5-flash",
    "gemini-2.0-flash-lite",
    "gemini-2.5-pro-exp-03-25",
    "gemini-2.5-flash-preview-04-17",
)
API_ROOT = "https://generativelanguage.googleapis.com/v1beta"


# the three tasks' instructions and defaults, shared with the on-card
# client (integrations/local_llm.py)
SPEAKER_TASK = (
    "The following are excerpts from a meeting transcript where "
    "speakers are labeled SPEAKER_00, SPEAKER_01, etc. Infer each "
    "speaker's real name from how they address each other. Reply "
    "with ONLY a JSON object mapping each speaker code to a name, "
    'e.g. {"SPEAKER_00": "Alice"}. If a name cannot be inferred, '
    "map the code to itself."
)
SUMMARY_TASK = (
    "Summarize this engineering meeting transcript. Reply with ONLY "
    "a JSON object with keys: \"title\" (a concise meeting title), "
    "\"summary\" (200-300 words), and \"todos\" (array of action-item "
    "strings)."
)
NOTES_TASK = (
    "Write detailed, well-structured meeting notes in Markdown from "
    "this transcript: use headings, bullet points, and a decisions/"
    "action-items section. Reply with the Markdown only."
)


def default_summary() -> dict[str, Any]:
    return {"title": "Meeting Notes", "summary": "Summary generation failed.", "todos": []}


def speaker_prompt(segments: list[dict], max_samples: int = 30) -> str:
    """The speaker task over samples taken evenly across the meeting."""
    step = max(1, -(-len(segments) // max_samples))  # ceil: stride 1
    # would sample only the meeting's start for 31..59 segments
    sample = segments[::step][:max_samples]
    lines = "\n".join(f"{s['speaker']}: {s['text']}" for s in sample)
    return SPEAKER_TASK + "\n\nTranscript excerpts:\n" + lines


def parse_speakers(text: str, speakers: list[str]) -> dict[str, str]:
    """{code: name} from the model's reply; a code it leaves out or names
    with no text maps to itself."""
    mapping = extract_json_object(text)
    mapping = mapping if isinstance(mapping, dict) else {}
    out = {}
    for s in speakers:
        name = mapping.get(s)
        out[s] = name if isinstance(name, str) and name.strip() else s
    return out


def parse_summary(text: str) -> dict[str, Any]:
    default = default_summary()
    data = extract_json_object(text)
    if not isinstance(data, dict):
        return default
    return {
        "title": str(data.get("title") or default["title"]),
        "summary": str(data.get("summary") or default["summary"]),
        "todos": [str(x) for x in data.get("todos") or []],
    }


class GeminiError(RuntimeError):
    pass


class QuotaExhausted(GeminiError):
    pass


def _default_http(
    url: str, headers: dict, payload: dict, timeout: float
) -> tuple[int, dict]:
    import requests

    resp = requests.post(url, headers=headers, json=payload, timeout=timeout)
    try:
        body = resp.json()
    except ValueError:
        body = {"error": {"message": resp.text[:500]}}
    return resp.status_code, body


class GeminiClient:
    def __init__(
        self,
        api_key: str | None = None,
        models: tuple[str, ...] | None = None,
        http: Callable[[str, dict, dict, float], tuple[int, dict]] | None = None,
        timeout: float = 120.0,
    ):
        self.api_key = api_key or os.environ.get("GEMINI_API_KEY", "")
        if models is None:
            env = os.environ.get("GEMINI_MODELS", "")
            models = (
                tuple(m.strip() for m in env.split(",") if m.strip())
                if env.strip() else DEFAULT_MODELS
            )
        self.models = models
        self.http = http or _default_http
        self.timeout = timeout

    @property
    def available(self) -> bool:
        return bool(self.api_key)

    # -- core ladder --------------------------------------------------------

    def generate(self, prompt: str, models: tuple[str, ...] | None = None) -> str:
        """Try each model in order; on 429/quota continue down the ladder,
        on other errors raise (reference semantics, :447-469)."""
        last_exc: Exception | None = None
        for model in models or self.models:
            # key rides the x-goog-api-key HEADER, never the URL: transport
            # exceptions embed the URL (str(exc) includes the query string)
            # and those strings land in server logs
            url = f"{API_ROOT}/models/{model}:generateContent"
            headers = {"x-goog-api-key": self.api_key}
            payload = {"contents": [{"parts": [{"text": prompt}]}]}
            try:
                status, body = self.http(url, headers, payload, self.timeout)
            except Exception as exc:  # transport error: try next model
                logger.warning("gemini %s transport error: %s", model, exc)
                last_exc = exc
                continue
            if status == 200:
                try:
                    return body["candidates"][0]["content"]["parts"][0]["text"]
                except (KeyError, IndexError, TypeError) as exc:
                    last_exc = GeminiError(f"{model}: malformed response")
                    logger.warning("gemini %s malformed response", model)
                    continue
            message = str(body.get("error", {}).get("message", ""))
            if status == 429 or "quota" in message.lower() or "exhausted" in message.lower():
                logger.info("gemini %s quota exhausted; trying next model", model)
                last_exc = QuotaExhausted(f"{model}: {message}")
                continue
            if status == 404 or "not found" in message.lower():
                # the ladder leads with time-limited preview endpoints; a
                # RETIRED model must not kill tasks four working fallbacks
                # could serve (divergence from the reference's raise-on-
                # other-errors, :460-469 — deliberate: its ladder died the
                # day Google retired gemini-2.5-pro-exp-03-25)
                logger.warning("gemini %s unavailable (%s); trying next model", model, message)
                last_exc = GeminiError(f"{model}: HTTP {status}: {message}")
                continue
            raise GeminiError(f"{model}: HTTP {status}: {message}")
        raise last_exc or QuotaExhausted("all Gemini models exhausted")

    # -- task: speaker identification (reference :932-976) ------------------

    def identify_speakers(self, segments: list[dict], max_samples: int = 30) -> dict[str, str]:
        """{SPEAKER_XX: real name} from transcript samples; identity map on
        any failure.  Samples are taken evenly across the meeting so late
        speakers are represented."""
        speakers = sorted({s["speaker"] for s in segments})
        if not segments or not self.available:
            return {s: s for s in speakers}
        prompt = speaker_prompt(segments, max_samples)
        try:
            # flash-tier subset of the CONFIGURED ladder (reference uses
            # flash models for this cheap task, :959) — the module-level
            # FLASH_MODELS ignored a GEMINI_MODELS / constructor override
            flash = tuple(m for m in self.models if "flash" in m)
            text = self.generate(prompt, models=flash or self.models)
            return parse_speakers(text, speakers)
        except Exception as exc:  # noqa: BLE001 — graceful degradation
            logger.warning("speaker identification failed: %s", exc)
            return {s: s for s in speakers}

    # -- task: summary / title / todos (reference :978-1030) ----------------

    def generate_summary(
        self, transcript: str, attachment_text: str = ""
    ) -> dict[str, Any]:
        if not self.available:
            return default_summary()
        context = (
            f"Reference documents:\n{attachment_text}\n\n" if attachment_text else ""
        )
        prompt = context + SUMMARY_TASK + "\n\nTranscript:\n" + transcript
        try:
            return parse_summary(self.generate(prompt))
        except Exception as exc:  # noqa: BLE001
            logger.warning("summary generation failed: %s", exc)
            return default_summary()

    # -- task: comprehensive notes (reference :478-502) ----------------------

    def generate_comprehensive_notes(self, transcript: str) -> str:
        if not self.available:
            return ""
        prompt = NOTES_TASK + "\n\n" + transcript
        try:
            return self.generate(prompt)
        except Exception as exc:  # noqa: BLE001
            logger.warning("notes generation failed: %s", exc)
            return ""


def extract_json_object(text: str) -> Any:
    """Parse the first balanced JSON object out of LLM output.

    Handles ```json fences and nested braces — unlike the reference's
    `({.*?})` regex, which stops at the first '}' and corrupts any nested
    payload (audio_processor.py:964)."""
    fence = re.search(r"```(?:json)?\s*(.*?)```", text, re.DOTALL)
    if fence:
        text = fence.group(1)
    start = text.find("{")
    while start != -1:
        depth = 0
        in_str = False
        esc = False
        for i in range(start, len(text)):
            ch = text[i]
            if esc:
                esc = False
                continue
            if ch == "\\":
                esc = True
            elif ch == '"' and not esc:
                in_str = not in_str
            elif not in_str:
                if ch == "{":
                    depth += 1
                elif ch == "}":
                    depth -= 1
                    if depth == 0:
                        try:
                            return json.loads(text[start : i + 1])
                        except ValueError:
                            break
        start = text.find("{", start + 1)
    return None
