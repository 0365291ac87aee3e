"""Notion pages: the meeting summary page + batched block appends.

Rebuild of the reference's create_notion_page (reference:
app/services/audio_processor.py:504-853): a database page titled
"<date> <title>" containing date heading, participants, summary callout,
to-do list, LLM meeting notes (markdown -> blocks), and the full
speaker-attributed transcript inside toggle blocks; created with <=90
blocks per request, the rest appended via PATCH
/v1/blocks/{id}/children with 3-attempt exponential backoff, 1 s pacing
between batches, and 401/403 short-circuit.

A copy of the JAX package's ``integrations/notion.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import logging
import os
import time
from datetime import datetime
from typing import Callable

from . import notion_formatter as nf
from ..utils.timestamps import format_timestamp

logger = logging.getLogger(__name__)

API_ROOT = "https://api.notion.com/v1"
NOTION_VERSION = "2022-06-28"


class NotionError(RuntimeError):
    pass


class NotionAuthError(NotionError):
    """401/403 — retrying is pointless (reference short-circuit :797-804)."""


def _default_http(
    method: str, url: str, headers: dict, payload: dict, timeout: float
) -> tuple[int, dict]:
    import requests

    resp = requests.request(method, url, headers=headers, json=payload, timeout=timeout)
    try:
        body = resp.json()
    except ValueError:
        body = {"message": resp.text[:500]}
    return resp.status_code, body


class NotionClient:
    def __init__(
        self,
        token: str | None = None,
        database_id: str | None = None,
        http: Callable | None = None,
        timeout: float = 60.0,
        batch_pause_s: float = 1.0,
    ):
        self.token = token or os.environ.get("NOTION_TOKEN", "")
        self.database_id = database_id or os.environ.get("NOTION_DATABASE_ID", "")
        self.http = http or _default_http
        self.timeout = timeout
        self.batch_pause_s = batch_pause_s

    @property
    def available(self) -> bool:
        return bool(self.token and self.database_id)

    def _headers(self) -> dict:
        return {
            "Authorization": f"Bearer {self.token}",
            "Content-Type": "application/json",
            "Notion-Version": NOTION_VERSION,
        }

    # -- low-level with retry ----------------------------------------------

    def _request(self, method: str, url: str, payload: dict, retries: int = 3) -> dict:
        delay = 1.0
        last: Exception | None = None
        for attempt in range(retries):
            if attempt:  # backoff before a retry, never after the last try
                time.sleep(delay)
                delay *= 2
            try:
                status, body = self.http(method, url, self._headers(), payload, self.timeout)
            except Exception as exc:  # transport error
                last = exc
                logger.warning("notion transport error (try %d): %s", attempt + 1, exc)
                continue
            if status in (200, 201):
                return body
            if status in (401, 403):
                raise NotionAuthError(f"HTTP {status}: {body.get('message', '')}")
            last = NotionError(f"HTTP {status}: {body.get('message', '')}")
            logger.warning("notion error (try %d): %s", attempt + 1, last)
        raise last or NotionError("notion request failed")

    # -- page assembly ------------------------------------------------------

    def build_header_blocks(
        self,
        formatted_date: str,
        participants: list[str],
        summary: str,
        todos: list[str],
        drive_link: str | None = None,
    ) -> list[dict]:
        blocks: list[dict] = []
        blocks.append(nf._block("heading_2", "📅 Date"))
        blocks.append(nf._block("paragraph", formatted_date))
        blocks.append({"object": "block", "type": "divider", "divider": {}})
        if participants:
            blocks.append(nf._block("heading_2", "👥 Participants"))
            for p in sorted(participants):
                blocks.append(nf._block("bulleted_list_item", p))
            blocks.append({"object": "block", "type": "divider", "divider": {}})
        if drive_link:
            blocks.append(
                {
                    "object": "block",
                    "type": "paragraph",
                    "paragraph": {
                        "rich_text": [
                            nf._text_obj("🔗 Source recording", link=drive_link)
                        ]
                    },
                }
            )
        blocks.append(nf._block("heading_2", "📝 Summary"))
        blocks.append(
            {
                "object": "block",
                "type": "callout",
                "callout": {
                    # no pre-truncation: rich_text splits long content
                    # into multiple <=2000-char text objects
                    "rich_text": nf.rich_text(summary),
                    "icon": {"type": "emoji", "emoji": "💡"},
                },
            }
        )
        if todos:
            blocks.append(nf._block("heading_2", "✅ Action items"))
            for todo in todos:
                blocks.append(nf._block("to_do", todo, checked=False))
        blocks.append({"object": "block", "type": "divider", "divider": {}})
        return blocks

    def create_meeting_page(
        self,
        title: str,
        summary: str,
        todos: list[str],
        segments: list[dict],
        speaker_map: dict[str, str],
        comprehensive_notes: str = "",
        date_str: str | None = None,
        drive_link: str | None = None,
    ) -> tuple[str, str]:
        """Create the page; returns (page_id, page_url)."""
        if not self.available:
            raise NotionError("missing NOTION_TOKEN / NOTION_DATABASE_ID")

        date_str = date_str or datetime.now().strftime("%Y-%m-%d")
        page_title = f"[{date_str}] {title}"

        participants = sorted({v for v in speaker_map.values() if v})
        blocks = self.build_header_blocks(
            date_str, participants, summary, todos, drive_link
        )
        note_blocks = nf.markdown_to_blocks(comprehensive_notes) if comprehensive_notes else []

        # a todo-heavy meeting can push the header past the per-request
        # block cap on its own: cap the CREATE payload as a whole and
        # append the overflow (header included) in later batches —
        # head_room may otherwise go negative and note_blocks[:negative]
        # stuffs hundreds of blocks into one 400-rejected request
        all_blocks = blocks + note_blocks
        first_batch = all_blocks[: nf.MAX_BLOCKS_PER_REQUEST]
        remaining = all_blocks[nf.MAX_BLOCKS_PER_REQUEST :]

        body = self._request(
            "POST",
            f"{API_ROOT}/pages",
            {
                "parent": {"database_id": self.database_id},
                "properties": {"title": {"title": [{"text": {"content": page_title}}]}},
                "children": first_batch,
            },
        )
        page_id = body["id"]
        page_url = body.get("url", f"https://www.notion.so/{page_id.replace('-', '')}")

        # transcript section
        transcript_lines = [
            f"[{format_timestamp(s['start'])}] {s['speaker']}: {s['text']}"
            for s in segments
        ]
        tail: list[dict] = list(remaining)
        tail.append({"object": "block", "type": "divider", "divider": {}})
        tail.append(nf._block("heading_2", "🎙️ Full transcript"))
        tail.extend(nf.transcript_toggle_blocks("\n".join(transcript_lines)))

        batches = nf.batch_blocks(tail)
        for i, batch in enumerate(batches):
            self._request(
                "PATCH",
                f"{API_ROOT}/blocks/{page_id}/children",
                {"children": batch},
            )
            # pace BETWEEN batches only — a flat sleep after the final
            # (often only) batch added dead wall time to every job
            if self.batch_pause_s and i + 1 < len(batches):
                time.sleep(self.batch_pause_s)
        return page_id, page_url
