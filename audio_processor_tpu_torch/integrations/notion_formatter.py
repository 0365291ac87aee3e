"""Markdown -> Notion block JSON formatter.

Covers the same markdown surface as the reference's stateful line parser
(reference: app/utils/notion_formatter.py:5-470): fenced code blocks with
language, pipe tables with header rows, blockquotes, headings clamped to
h3, `[ ]`/`[x]` todos, numbered/bulleted lists, `---` dividers, paragraphs,
and inline code/bold/italic/strikethrough/links; plus the transcript
splitter (Notion's 2000-char rich_text limit) and the <=100-blocks-per-
request batcher.  Implementation is an original single-pass parser emitting
Notion API (2022-06-28) block payloads.

A copy of the JAX package's ``integrations/notion_formatter.py``: the PyTorch package
imports nothing of that package.
"""
from __future__ import annotations

import re

MAX_TEXT_LEN = 2000  # Notion rich_text content limit
MAX_BLOCKS_PER_REQUEST = 90  # batch below Notion's hard 100 cap

_NOTION_LANGS = {
    "python", "javascript", "typescript", "java", "c", "c++", "c#", "go",
    "rust", "ruby", "php", "swift", "kotlin", "scala", "shell", "bash",
    "sql", "html", "css", "json", "yaml", "xml", "markdown", "plain text",
}


# ---------------------------------------------------------------------------
# Inline formatting -> rich_text
# ---------------------------------------------------------------------------

_INLINE_RE = re.compile(
    r"(?P<code>`[^`]+`)"
    r"|(?P<bolditalic>\*\*\*[^*]+\*\*\*)"
    r"|(?P<bold>\*\*[^*]+\*\*)"
    # underscore emphasis follows CommonMark's no-intraword rule
    # ((?<!\w) / (?!\w) flanks + non-space at both inner edges):
    # engineering notes are full of snake_case identifiers, and the
    # unflanked pattern turned 'speaker_map to file_id' into italics
    r"|(?P<italic>\*[^*\s][^*]*\*"
    r"|(?<!\w)_[^_\s](?:[^_]*[^_\s])?_(?!\w))"
    r"|(?P<strike>~~[^~]+~~)"
    r"|(?P<link>\[[^\]]+\]\([^)]+\))"
)

_LINK_RE = re.compile(r"\[([^\]]+)\]\(([^)]+)\)")


def _text_obj(content: str, annotations: dict | None = None, link: str | None = None) -> dict:
    obj: dict = {"type": "text", "text": {"content": content}}
    if link:
        obj["text"]["link"] = {"url": link}
    if annotations:
        obj["annotations"] = annotations
    return obj


def rich_text(text: str) -> list[dict]:
    """Markdown inline formatting -> Notion rich_text array."""
    out: list[dict] = []
    pos = 0
    for m in _INLINE_RE.finditer(text):
        if m.start() > pos:
            out.append(_text_obj(text[pos : m.start()]))
        token = m.group(0)
        kind = m.lastgroup
        if kind == "code":
            out.append(_text_obj(token[1:-1], {"code": True}))
        elif kind == "bolditalic":
            out.append(_text_obj(token[3:-3], {"bold": True, "italic": True}))
        elif kind == "bold":
            out.append(_text_obj(token[2:-2], {"bold": True}))
        elif kind == "italic":
            out.append(_text_obj(token[1:-1], {"italic": True}))
        elif kind == "strike":
            out.append(_text_obj(token[2:-2], {"strikethrough": True}))
        elif kind == "link":
            lm = _LINK_RE.match(token)
            label, url = lm.group(1), lm.group(2)
            out.append(_text_obj(label, link=url))
        pos = m.end()
    if pos < len(text):
        out.append(_text_obj(text[pos:]))
    # enforce Notion's per-object content limit
    clipped: list[dict] = []
    for obj in out:
        content = obj["text"]["content"]
        while len(content) > MAX_TEXT_LEN:
            head = dict(obj, text=dict(obj["text"], content=content[:MAX_TEXT_LEN]))
            clipped.append(head)
            content = content[MAX_TEXT_LEN:]
        clipped.append(dict(obj, text=dict(obj["text"], content=content)))
    return clipped or [_text_obj("")]


# ---------------------------------------------------------------------------
# Block-level parsing
# ---------------------------------------------------------------------------

def _block(block_type: str, text: str | None = None, **extra) -> dict:
    payload = dict(extra)
    if text is not None:
        payload["rich_text"] = rich_text(text)
    return {"object": "block", "type": block_type, block_type: payload}


_HEADING_RE = re.compile(r"^(#{1,6})\s+(.*)$")
_TODO_RE = re.compile(r"^[-*]\s+\[( |x|X)\]\s+(.*)$")
_BULLET_RE = re.compile(r"^[-*+]\s+(.*)$")
_NUMBERED_RE = re.compile(r"^\d+[.)]\s+(.*)$")
_DIVIDER_RE = re.compile(r"^(-{3,}|\*{3,}|_{3,})\s*$")
_TABLE_ROW_RE = re.compile(r"^\|(.+)\|\s*$")
_TABLE_SEP_RE = re.compile(r"^\|?[\s:|-]+\|?\s*$")


def markdown_to_blocks(markdown: str) -> list[dict]:
    """Full markdown document -> list of Notion block dicts."""
    blocks: list[dict] = []
    lines = markdown.split("\n")
    i = 0
    while i < len(lines):
        line = lines[i]
        stripped = line.strip()

        # fenced code
        if stripped.startswith("```"):
            lang = stripped[3:].strip().lower() or "plain text"
            if lang not in _NOTION_LANGS:
                lang = "plain text"
            body: list[str] = []
            i += 1
            while i < len(lines) and not lines[i].strip().startswith("```"):
                body.append(lines[i])
                i += 1
            i += 1  # closing fence
            code = "\n".join(body)
            blocks.append(
                {
                    "object": "block",
                    "type": "code",
                    "code": {
                        # split, don't truncate: the 2000-char cap is per
                        # text OBJECT, and one code block takes many
                        "rich_text": [
                            _text_obj(code[j : j + MAX_TEXT_LEN])
                            for j in range(0, len(code), MAX_TEXT_LEN)
                        ]
                        or [_text_obj("")],
                        "language": lang,
                    },
                }
            )
            continue

        # table
        if _TABLE_ROW_RE.match(stripped):
            rows: list[list[str]] = []
            has_header = False
            while i < len(lines) and _TABLE_ROW_RE.match(lines[i].strip()):
                cells_line = lines[i].strip().strip("|")
                if _TABLE_SEP_RE.match(lines[i].strip()) and rows:
                    has_header = True
                else:
                    rows.append([c.strip() for c in cells_line.split("|")])
                i += 1
            if rows:
                width = max(len(r) for r in rows)
                table_rows = [
                    {
                        "object": "block",
                        "type": "table_row",
                        "table_row": {
                            "cells": [
                                rich_text(r[c] if c < len(r) else "")
                                for c in range(width)
                            ]
                        },
                    }
                    for r in rows
                ]
                blocks.append(
                    {
                        "object": "block",
                        "type": "table",
                        "table": {
                            "table_width": width,
                            "has_column_header": has_header,
                            "has_row_header": False,
                            "children": table_rows,
                        },
                    }
                )
            continue

        # quote (merge consecutive quote lines)
        if stripped.startswith(">"):
            quote_lines = []
            while i < len(lines) and lines[i].strip().startswith(">"):
                quote_lines.append(lines[i].strip().lstrip(">").strip())
                i += 1
            blocks.append(_block("quote", " ".join(quote_lines)))
            continue

        m = _HEADING_RE.match(stripped)
        if m:
            level = min(len(m.group(1)), 3)  # Notion supports h1..h3
            blocks.append(_block(f"heading_{level}", m.group(2)))
            i += 1
            continue

        m = _TODO_RE.match(stripped)
        if m:
            blocks.append(
                _block("to_do", m.group(2), checked=m.group(1).lower() == "x")
            )
            i += 1
            continue

        if _DIVIDER_RE.match(stripped):
            blocks.append({"object": "block", "type": "divider", "divider": {}})
            i += 1
            continue

        m = _NUMBERED_RE.match(stripped)
        if m:
            blocks.append(_block("numbered_list_item", m.group(1)))
            i += 1
            continue

        m = _BULLET_RE.match(stripped)
        if m:
            blocks.append(_block("bulleted_list_item", m.group(1)))
            i += 1
            continue

        if stripped:
            blocks.append(_block("paragraph", stripped))
        i += 1
    return blocks


# ---------------------------------------------------------------------------
# Transcript handling + batching
# ---------------------------------------------------------------------------

def split_transcript_into_blocks(transcript: str) -> list[dict]:
    """Long transcript -> paragraph blocks, each under the 2000-char limit,
    split on line boundaries where possible (reference:
    notion_formatter.py:420-459)."""
    blocks = []
    current: list[str] = []
    size = 0
    for line in transcript.split("\n"):
        extra = len(line) + 1
        if size + extra > MAX_TEXT_LEN and current:
            blocks.append(_paragraph_plain("\n".join(current)))
            current, size = [], 0
        while len(line) > MAX_TEXT_LEN:  # single pathological line
            blocks.append(_paragraph_plain(line[:MAX_TEXT_LEN]))
            line = line[MAX_TEXT_LEN:]
        current.append(line)
        size += extra
    if current and any(s.strip() for s in current):
        blocks.append(_paragraph_plain("\n".join(current)))
    return blocks


def _paragraph_plain(text: str) -> dict:
    return {
        "object": "block",
        "type": "paragraph",
        "paragraph": {"rich_text": [_text_obj(text)]},
    }


def transcript_toggle_blocks(transcript: str, title: str = "Full transcript") -> list[dict]:
    """Transcript inside toggle blocks, split into parts of <=90 children
    (Notion's children cap per block; reference: notion_formatter.py:735-771)."""
    paragraphs = split_transcript_into_blocks(transcript)
    if not paragraphs:
        return []
    parts = [
        paragraphs[i : i + MAX_BLOCKS_PER_REQUEST]
        for i in range(0, len(paragraphs), MAX_BLOCKS_PER_REQUEST)
    ]
    toggles = []
    for n, part in enumerate(parts, start=1):
        label = title if len(parts) == 1 else f"{title} (part {n}/{len(parts)})"
        toggles.append(
            {
                "object": "block",
                "type": "toggle",
                "toggle": {"rich_text": [_text_obj(label)], "children": part},
            }
        )
    return toggles


def _block_weight(block: dict) -> int:
    """Blocks a request really carries: the block plus its nested children
    (a transcript toggle holds up to 90 paragraph children — counting it
    as 1 let a single batch blow Notion's total-block/payload limits)."""
    n = 1
    body = block.get(block.get("type"), {})
    for child in body.get("children", []) or []:
        n += _block_weight(child)
    return n


def batch_blocks(blocks: list[dict], batch_size: int = MAX_BLOCKS_PER_REQUEST) -> list[list[dict]]:
    """Split a block list into API-request-sized batches.

    Batches are bounded by total WEIGHT (top-level + nested children,
    <= batch_size); an oversized single block still ships alone as its
    own request."""
    batches: list[list[dict]] = []
    cur: list[dict] = []
    cur_w = 0
    for block in blocks:
        w = _block_weight(block)
        if cur and cur_w + w > batch_size:
            batches.append(cur)
            cur, cur_w = [], 0
        cur.append(block)
        cur_w += w
    if cur:
        batches.append(cur)
    return batches
