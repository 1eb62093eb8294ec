"""Snippet + highlight generation.

Parity target: reference crates/frankensearch-quill/src/snippet.rs —
Tantivy-equivalent snippet generation: pick the highest-scoring window of
the document around query-term matches, mark matched term ranges.
"""

from __future__ import annotations

from dataclasses import dataclass

from frankensearch_tpu_torch.lexical.tokenizer import simple_tokenize


@dataclass(frozen=True)
class Snippet:
    text: str
    #: (start, end) char ranges of highlighted terms within `text`
    highlights: tuple[tuple[int, int], ...]

    def to_html(self) -> str:
        out = []
        pos = 0
        for start, end in self.highlights:
            out.append(self.text[pos:start])
            out.append(f"<b>{self.text[start:end]}</b>")
            pos = end
        out.append(self.text[pos:])
        return "".join(out)


def generate_snippet(
    text: str, query: str, *, max_chars: int = 150
) -> Snippet:
    """Best window by (distinct term hits, total hits) with word-boundary
    trimming; falls back to the document head when nothing matches."""
    terms = set(simple_tokenize(query))
    if not terms or not text:
        head = text[:max_chars]
        return Snippet(text=head, highlights=())

    # locate term occurrences (char ranges) by scanning tokens with offsets
    matches: list[tuple[int, int, str]] = []
    i = 0
    lowered = text.lower()
    n = len(text)
    while i < n:
        if lowered[i].isalnum():
            j = i
            while j < n and lowered[j].isalnum():
                j += 1
            tok = lowered[i:j]
            if tok in terms:
                matches.append((i, j, tok))
            i = j
        else:
            i += 1
    if not matches:
        head = text[:max_chars]
        return Snippet(text=head, highlights=())

    # best window: slide over matches, score = (#distinct terms, #hits)
    best_start, best_score = 0, (-1, -1)
    for a in range(len(matches)):
        window_terms: set[str] = set()
        hits = 0
        for b in range(a, len(matches)):
            if matches[b][1] - matches[a][0] > max_chars:
                break
            window_terms.add(matches[b][2])
            hits += 1
        score = (len(window_terms), hits)
        if score > best_score:
            best_score = score
            best_start = a

    w_start = matches[best_start][0]
    # expand left to a word boundary, up to ~20% of the window
    left = max(0, w_start - max_chars // 5)
    while left > 0 and text[left - 1].isalnum():
        left -= 1
    right = min(n, left + max_chars)
    while right < n and text[right].isalnum():
        right += 1
    window = text[left:right]
    highlights = tuple(
        (s - left, e - left) for s, e, _ in matches if s >= left and e <= right
    )
    prefix = "…" if left > 0 else ""
    suffix = "…" if right < n else ""
    shift = len(prefix)
    return Snippet(
        text=prefix + window + suffix,
        highlights=tuple((s + shift, e + shift) for s, e in highlights),
    )
