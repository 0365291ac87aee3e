"""The meeting job's language-model tasks on the card, with DeepSeek-V2
or Kimi-Linear (``APTPU_LOCAL_LLM`` names the preset).

``LocalLLMClient`` does ``GeminiClient``'s tasks with its instructions and
graceful defaults (identity speaker map, "Meeting Notes" / "Summary
generation failed.", empty notes), for teams whose transcripts may not
leave their machines: speaker identification, and the summary (title and
action items) with the meeting notes.  Each task takes a batch of
meetings (the job's ``MeetingProcessor.write_up`` hands it one meeting, a
backlog job all of them) and runs it as calls of the engine of at most
the preset's ``max_meetings`` meetings each.  Prompts follow DeepSeek-V2-Chat's layout
(``<BOS>User: ...\\n\\nAssistant:``, with the model's own BOS) and put the
transcript first, so the summary and the notes decode as two rows of one
prefilled transcript (``models/llm/generate.py``).

Kimi-Linear-48B-A3B is published as a model for two cards in expert
parallelism: one card holds half of each layer's 256 experts (the preset
holds experts 0-127) and, without a mesh whose model group holds the
other half, computes only that half (the engine warns when it loads).

Decoding is greedy, to at most ``speaker_tokens``, ``summary_tokens`` and
``notes_tokens`` new tokens.  Without published weights and tokenizer in
the repository, ``random_init`` draws seeded weights and the byte
tokenizer stands in: the output is noise, its JSON does not parse, and
the defaults hold.
"""
from __future__ import annotations

import logging
from typing import Any

from .gemini import NOTES_TASK, SUMMARY_TASK, parse_speakers, parse_summary, speaker_prompt

logger = logging.getLogger(__name__)


class LocalLLMClient:
    """Greedy DeepSeek-V2 or Kimi-Linear on one device, behind the Gemini
    client's tasks."""

    available = True
    # new-token caps: a JSON map of up to six names; a title, 200-300 words
    # and action items; notes with headings and action items
    speaker_tokens, summary_tokens, notes_tokens = 96, 512, 1024

    @classmethod
    def card_bytes(cls, name: str = "deepseek-v2-lite") -> int:
        """The peak the engine of preset ``name`` takes on the card: its
        bf16 weights (this card's experts) and the preset's ``work_bytes``
        (the latent caches and KDA states, the prefill's chunks, the kept
        prefix buffers and the graphs' pools at its largest call)."""
        import math

        from ..models.llm.checkpoint import param_spec
        from ..models.llm.config import get_config

        cfg = get_config(name)
        n = sum(math.prod(shape) for _, shape, _, _ in param_spec(cfg))
        return 2 * n + cfg.work_bytes

    def __init__(self, engine, tokenizer=None):
        from ..models.llm.tokenizer import ByteTokenizer

        self.engine = engine
        self.tokenizer = tokenizer or ByteTokenizer()
        # meetings a call of the engine at most: the preset's measured call
        self.max_meetings = engine.cfg.max_meetings

    @classmethod
    def random_init(cls, name: str = "deepseek-v2-lite", device=None) -> "LocalLLMClient":
        """Weights of the preset ``name`` drawn from seed 0 (no checkpoint),
        in bfloat16 on the card and float32 on the CPU."""
        import torch

        from ..models.llm.checkpoint import random_params
        from ..models.llm.config import get_config
        from ..models.llm.generate import Engine
        from ..runtime.device import resolve_device

        cfg = get_config(name)
        dev = resolve_device(device)
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        return cls(Engine(random_params(cfg, 0, dev, dtype), cfg, dev))

    # -- prompts ---------------------------------------------------------

    def prompt(self, content: str) -> list[int]:
        """DeepSeek-V2-Chat's single-turn layout, after the model's BOS."""
        return [self.engine.cfg.bos_token_id] + self.tokenizer.encode(
            f"User: {content}\n\nAssistant:")

    def write_up_prompts(self, transcript: str, attachment_text: str = "") -> list[list[int]]:
        """The summary's and the notes' prompts, transcript first, so that
        the two share the transcript as one prefix."""
        head = f"Transcript:\n{transcript}\n\n"
        context = f"Reference documents:\n{attachment_text}\n\n" if attachment_text else ""
        return [self.prompt(head + context + SUMMARY_TASK), self.prompt(head + NOTES_TASK)]

    def text(self, ids: list[int]) -> str:
        eos = self.engine.cfg.eos_token_id
        return self.tokenizer.decode([i for i in ids if i != eos]).strip()

    # -- the tasks, a batch of meetings a call -------------------------------

    def _generate(self, task: str, groups: list[list[list[int]]], caps: list[list[int]]):
        """The engine's continuations, or empty ones and a warning if it
        fails: the task's defaults then hold, as Gemini's do."""
        try:
            return self.engine.generate(groups, caps)
        except Exception as exc:  # noqa: BLE001 — graceful degradation, as Gemini's
            logger.warning("%s failed: %s", task, exc)
            return [[[] for _ in g] for g in groups]

    def identify_speakers_many(self, segment_lists: list[list[dict]],
                               max_samples: int = 30) -> list[dict[str, str]]:
        """Each meeting's {speaker code: name} (``{}`` for a meeting
        without segments)."""
        out: list[dict[str, str]] = [{} for _ in segment_lists]
        asked = [i for i, segs in enumerate(segment_lists) if segs]
        for part in _slices(asked, self.max_meetings):
            prompts = [[self.prompt(speaker_prompt(segment_lists[i], max_samples))] for i in part]
            gens = self._generate("speaker identification", prompts,
                                  [[self.speaker_tokens]] * len(part))
            for i, (ids,) in zip(part, gens):
                speakers = sorted({s["speaker"] for s in segment_lists[i]})
                out[i] = parse_speakers(self.text(ids), speakers)
        return out

    def summary_and_notes_many(self, meetings: list[tuple[str, str]]
                               ) -> list[tuple[dict[str, Any], str]]:
        """Each meeting's summary (title, summary, todos) and notes, from
        its (transcript, attachment text)."""
        out = []
        for part in _slices(meetings, self.max_meetings):
            gens = self._generate("summary generation",
                                  [self.write_up_prompts(t, a) for t, a in part],
                                  [[self.summary_tokens, self.notes_tokens]] * len(part))
            out += [(parse_summary(self.text(summary)), self.text(notes))
                    for summary, notes in gens]
        return out


def _slices(items: list, n: int) -> list[list]:
    return [items[i:i + n] for i in range(0, len(items), n)]
