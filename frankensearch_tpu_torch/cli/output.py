"""Versioned CLI output envelopes + renderers.

Parity target: reference crates/frankensearch-fsfs/src/output_schema.rs —
``OutputEnvelope`` ``{v, ok, data, error, warnings}`` with table / json /
jsonl / csv / toon render modes (cli.rs output formats; toon is the
token-budget agent mode, agent_ergonomics.rs compact payloads).
"""

from __future__ import annotations

import csv
import io
import json
from typing import Any, Sequence

ENVELOPE_VERSION = 1


def envelope(
    data: Any, ok: bool = True, error: dict | None = None, warnings: Sequence[str] = ()
) -> dict:
    return {
        "v": ENVELOPE_VERSION,
        "ok": ok,
        "data": data,
        "error": error,
        "warnings": list(warnings),
    }


def error_envelope(code: str, message: str, warnings: Sequence[str] = ()) -> dict:
    return envelope(None, ok=False, error={"code": code, "message": message}, warnings=warnings)


def render(env: dict, fmt: str, table_fields: Sequence[str] | None = None) -> str:
    if fmt == "toon":
        return _render_toon(env)
    if fmt == "json":
        return json.dumps(env, indent=2, default=str)
    if fmt == "jsonl":
        data = env.get("data")
        rows = data if isinstance(data, list) else [env]
        return "\n".join(json.dumps(r, default=str) for r in rows)
    if fmt == "csv":
        data = env.get("data") or []
        if not isinstance(data, list) or not data:
            return ""
        fields = table_fields or sorted({k for row in data for k in row})
        buf = io.StringIO()
        w = csv.DictWriter(buf, fieldnames=fields, extrasaction="ignore")
        w.writeheader()
        for row in data:
            w.writerow({k: _csv_guard(v) for k, v in row.items()})
        return buf.getvalue().rstrip("\n")
    return _render_table(env, table_fields)


def _render_toon(env: dict) -> str:
    """Token-budget-friendly agent format (cli.rs `toon` mode /
    agent_ergonomics.rs compact payloads): one `k=v` line per row, no
    envelope boilerplate, nulls dropped, floats short. Errors render as
    one `!code message` line so an agent can branch on the first char.
    Values pass the same control-char escaping as the table renderer
    (untrusted corpora must not inject terminal escapes)."""
    if not env.get("ok"):
        err = env.get("error") or {}
        return f"!{err.get('code', '?')} {_cell(err.get('message', ''))}"
    data = env.get("data")
    lines: list[str] = []
    if isinstance(data, list):
        for row in data:
            if isinstance(row, dict):
                lines.append(" ".join(
                    f"{k}={_toon_val(v)}" for k, v in row.items() if v is not None
                ))
            else:
                lines.append(_cell(row))
    elif isinstance(data, dict):
        lines.append(" ".join(
            f"{k}={_toon_val(v)}" for k, v in data.items() if v is not None
        ))
    elif data is not None:
        lines.append(_cell(data))
    for w in env.get("warnings", []):
        lines.append(f"~{_cell(w)}")
    return "\n".join(lines)


def _toon_val(v: Any) -> str:
    if isinstance(v, float):
        s = f"{v:.4g}"
    elif isinstance(v, (dict, list)):
        s = json.dumps(v, separators=(",", ":"), default=str)
    else:
        s = _cell(v)
    # keep one row = one line = whitespace-splittable fields
    if " " in s or "\t" in s:
        s = json.dumps(s)
    return s


def _render_table(env: dict, table_fields: Sequence[str] | None) -> str:
    lines: list[str] = []
    if not env.get("ok"):
        err = env.get("error") or {}
        lines.append(f"error [{err.get('code', '?')}]: {err.get('message', '')}")
    data = env.get("data")
    if isinstance(data, list) and data and isinstance(data[0], dict):
        fields = list(table_fields or data[0].keys())
        widths = {
            f: max(len(str(f)), *(len(_cell(row.get(f))) for row in data)) for f in fields
        }
        header = "  ".join(str(f).ljust(widths[f]) for f in fields)
        lines.append(header)
        lines.append("  ".join("-" * widths[f] for f in fields))
        for row in data:
            lines.append("  ".join(_cell(row.get(f)).ljust(widths[f]) for f in fields))
    elif isinstance(data, dict):
        for k, v in data.items():
            lines.append(f"{k}: {_cell(v)}")
    elif data is not None:
        lines.append(str(data))
    for w in env.get("warnings", []):
        lines.append(f"warning: {w}")
    return "\n".join(lines)


def _cell(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.4f}"
    if isinstance(v, (dict, list)):
        return json.dumps(v, default=str)
    # doc ids/content come from UNTRUSTED corpora: raw C0 control chars
    # in a terminal table are an escape-injection vector (ANSI sequences
    # can retitle/rewrite the terminal) and newlines break row framing —
    # render them as visible escapes instead
    s = str(v)
    if any(ord(c) < 0x20 or ord(c) == 0x7F for c in s):
        s = "".join(
            c if (ord(c) >= 0x20 and ord(c) != 0x7F) else repr(c)[1:-1]
            for c in s
        )
    return s


def _csv_guard(v: Any):
    """Spreadsheet formula-injection guard (untrusted doc ids/snippets):
    cells starting with = + - @ or a control char get a leading ' so
    Excel/Sheets treat them as text (the csv module already quotes
    delimiters/newlines)."""
    if isinstance(v, str) and v and (v[0] in "=+-@" or ord(v[0]) < 0x20):
        return "'" + v
    return v
