"""Engine-neutral boolean query trees + lenient parser.

Parity target: reference crates/frankensearch-quill/src/query.rs —
engine-neutral query trees (term / phrase / AND / OR / NOT), a lenient
default parser (bad syntax degrades to terms instead of erroring),
canonicalization diagnostics, and MAX_QUERY_DEPTH/LENGTH guards.

Evaluation here runs against any LexicalRead-style postings source via
a document-predicate compilation (the scorer-tree role of argus.rs is
already covered by the BM25 scorers; the boolean tree FILTERS the
candidate set and phrase terms feed scoring).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from frankensearch_tpu_torch.lexical.tokenizer import simple_tokenize

MAX_QUERY_LENGTH = 1024
MAX_QUERY_DEPTH = 16


@dataclass(frozen=True)
class Term:
    text: str


@dataclass(frozen=True)
class Phrase:
    terms: tuple[str, ...]


@dataclass(frozen=True)
class And:
    children: tuple["Node", ...]


@dataclass(frozen=True)
class Or:
    children: tuple["Node", ...]


@dataclass(frozen=True)
class Not:
    child: "Node"


Node = Term | Phrase | And | Or | Not


@dataclass
class ParseDiagnostics:
    warnings: list[str] = field(default_factory=list)
    truncated: bool = False
    depth_clamped: bool = False


@dataclass(frozen=True)
class ParsedBooleanQuery:
    root: Node | None
    diagnostics: ParseDiagnostics

    def positive_terms(self) -> list[str]:
        """Terms usable for scoring (everything not under a NOT)."""
        out: list[str] = []

        def walk(node: Node, negated: bool) -> None:
            if isinstance(node, Term):
                if not negated:
                    out.append(node.text)
            elif isinstance(node, Phrase):
                if not negated:
                    out.extend(node.terms)
            elif isinstance(node, (And, Or)):
                for c in node.children:
                    walk(c, negated)
            elif isinstance(node, Not):
                walk(node.child, not negated)

        if self.root is not None:
            walk(self.root, False)
        return out


class _Tokens:
    def __init__(self, items: list[str]) -> None:
        self.items = items
        self.pos = 0

    def peek(self) -> str | None:
        return self.items[self.pos] if self.pos < len(self.items) else None

    def next(self) -> str | None:
        tok = self.peek()
        if tok is not None:
            self.pos += 1
        return tok


def _lex(raw: str, diag: ParseDiagnostics) -> list[str]:
    out: list[str] = []
    i, n = 0, len(raw)
    while i < n:
        c = raw[i]
        if c.isspace():
            i += 1
        elif c in "()":
            out.append(c)
            i += 1
        elif c == '"':
            j = raw.find('"', i + 1)
            if j < 0:
                diag.warnings.append("unterminated phrase quote; treating as terms")
                i += 1
            else:
                out.append(raw[i : j + 1])
                i = j + 1
        else:
            j = i
            while j < n and not raw[j].isspace() and raw[j] not in '()"':
                j += 1
            out.append(raw[i:j])
            i = j
    return out


def parse_query(raw: str) -> ParsedBooleanQuery:
    """Lenient recursive-descent parse of ``a AND (b OR "c d") NOT e``.
    Bare adjacency is OR (the default Should union, matching the
    reference's lenient parser)."""
    diag = ParseDiagnostics()
    if len(raw) > MAX_QUERY_LENGTH:
        raw = raw[:MAX_QUERY_LENGTH]
        diag.truncated = True
    tokens = _Tokens(_lex(raw, diag))

    def parse_group(depth: int) -> Node | None:
        if depth > MAX_QUERY_DEPTH:
            diag.depth_clamped = True
            # swallow until matching close paren
            while tokens.peek() not in (None, ")"):
                tokens.next()
            return None
        items: list[Node] = []
        op: str | None = None
        pending_not = False
        while True:
            tok = tokens.peek()
            if tok is None or tok == ")":
                break
            tokens.next()
            # operators are UPPERCASE-ONLY, matching is_boolean_syntax's
            # routing check: lowercase 'and'/'or'/'not' stay ordinary
            # terms, so a quoted phrase cannot silently promote the rest
            # of a natural-language query into boolean semantics
            # (review finding)
            if tok in ("AND", "OR"):
                if not items:
                    diag.warnings.append(f"leading {tok} ignored")
                    continue
                if op is not None and op != tok:
                    diag.warnings.append(
                        f"mixed AND/OR without parens; keeping {op}"
                    )
                    continue
                op = tok
                continue
            if tok == "NOT" or tok == "-":
                pending_not = True
                continue
            node: Node | None
            if tok == "(":
                node = parse_group(depth + 1)
                if tokens.peek() == ")":
                    tokens.next()
                else:
                    diag.warnings.append("unbalanced parenthesis")
            elif tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
                terms = tuple(simple_tokenize(tok[1:-1]))
                node = Phrase(terms) if terms else None
            elif tok.startswith("-") and len(tok) > 1:
                inner = simple_tokenize(tok[1:])
                node = Not(Term(inner[0])) if inner else None
                if node is not None:
                    items.append(node)
                continue
            else:
                terms = simple_tokenize(tok)
                node = Term(terms[0]) if terms else None
                if node is not None and len(terms) > 1:
                    node = And(tuple(Term(t) for t in terms))
            if node is None:
                pending_not = False
                continue
            if pending_not:
                node = Not(node)
                pending_not = False
            items.append(node)
        if not items:
            return None
        if len(items) == 1:
            return items[0]
        if op == "AND":
            return And(tuple(items))
        if op is None:
            # bare adjacency: positives union (Should), but a bare Not is
            # a Must-Not over the whole group — `alpha -noise` means
            # (alpha) AND NOT (noise), matching ParsedQuery's negation
            # contract (parsed_query.rs), not "alpha OR lacks-noise"
            nots = tuple(n for n in items if isinstance(n, Not))
            pos = tuple(n for n in items if not isinstance(n, Not))
            if nots and pos:
                pos_node: Node = pos[0] if len(pos) == 1 else Or(pos)
                return And((pos_node,) + nots)
        return Or(tuple(items))

    root = parse_group(0)
    return ParsedBooleanQuery(root=root, diagnostics=diag)


_BOOL_SYNTAX = None


def is_boolean_syntax(raw: str) -> bool:
    """Cheap routing check: does the raw query use boolean/phrase syntax
    (quotes, parens, or uppercase AND/OR/NOT operators)? Plain `-term`
    negation stays on the classic ParsedQuery lane — its split/filter
    contract already covers it."""
    global _BOOL_SYNTAX
    if _BOOL_SYNTAX is None:
        import re

        _BOOL_SYNTAX = re.compile(r'"|\(|\)|(?<![\w-])(?:AND|OR|NOT)(?![\w-])')
    return _BOOL_SYNTAX.search(raw) is not None


def has_structure(query: ParsedBooleanQuery) -> bool:
    """True when the tree carries constraints beyond a bag of terms —
    phrases, NOTs, or explicit AND groups. Structured queries route
    through the boolean lane (query.rs trees drive scoring); plain
    term bags keep the classic Should-union path."""

    def walk(node: Node) -> bool:
        if isinstance(node, (Phrase, Not)):
            return True
        if isinstance(node, And):
            return True
        if isinstance(node, Or):
            return any(walk(c) for c in node.children)
        return False

    return query.root is not None and walk(query.root)


def to_fts5_match(node: Node) -> str | None:
    """Compile a query tree to FTS5 MATCH syntax, or None when the tree
    is not expressible (FTS5 NOT is binary: pure-negative roots and NOTs
    under OR have no MATCH form — callers fall back to post-filtering).
    """

    def quote(t: str) -> str:
        return '"' + t.replace('"', '""') + '"'

    def compile_pos(n: Node) -> str | None:
        """Compile a node that must NOT contain a Not at this level."""
        if isinstance(n, Term):
            return quote(n.text)
        if isinstance(n, Phrase):
            return quote(" ".join(n.terms)) if n.terms else None
        if isinstance(n, Or):
            parts = [compile_pos(c) for c in n.children]
            if any(p is None for p in parts):
                return None  # NOT under OR: inexpressible
            return "(" + " OR ".join(p for p in parts if p) + ")"
        if isinstance(n, And):
            pos = [c for c in n.children if not isinstance(c, Not)]
            neg = [c.child for c in n.children if isinstance(c, Not)]
            pos_parts = [compile_pos(c) for c in pos]
            if not pos_parts or any(p is None for p in pos_parts):
                return None
            expr = "(" + " AND ".join(pos_parts) + ")"
            for nchild in neg:
                nexpr = compile_pos(nchild)
                if nexpr is None:
                    return None
                expr = f"({expr} NOT {nexpr})"
            return expr
        return None  # bare Not handled by And; root-level Not → None

    return compile_pos(node)


# --- evaluation --------------------------------------------------------------


#: field separator token for multi-field match streams — never produced
#: by the tokenizer, so phrases cannot span a field boundary
FIELD_SEP = "\x00"


def field_tokens(*texts: str | None) -> list[str]:
    """Tokenize multiple fields into one match stream: term membership is
    the union of fields; FIELD_SEP blocks cross-field phrase adjacency
    (the oracle's union-of-fields match-set semantics)."""
    out: list[str] = []
    for t in texts:
        if not t:
            continue
        if out:
            out.append(FIELD_SEP)
        out.extend(simple_tokenize(t))
    return out


def matches(node: Node, doc_tokens: Sequence[str]) -> bool:
    """Evaluate a query tree against a tokenized document (phrase = exact
    consecutive token run)."""
    token_set = set(doc_tokens)
    if isinstance(node, Term):
        return node.text in token_set
    if isinstance(node, Phrase):
        k = len(node.terms)
        if k == 0:
            return True
        target = tuple(node.terms)
        return any(
            tuple(doc_tokens[i : i + k]) == target
            for i in range(len(doc_tokens) - k + 1)
        )
    if isinstance(node, And):
        return all(matches(c, doc_tokens) for c in node.children)
    if isinstance(node, Or):
        return any(matches(c, doc_tokens) for c in node.children)
    if isinstance(node, Not):
        return not matches(node.child, doc_tokens)
    return False


def tree_drop_verdict(root, tokens, *, full_known: bool, positive_terms) -> bool:
    """Shared post-retrieval tree filter: True = DROP the doc.

    One implementation for BOTH consumers (the device-arm
    ``search_boolean`` post-filter and the fused-result constraint
    filter) — they drifted once and diverged on identical queries.

    Semantics: a matching tree always keeps. On a failed match,
    ``full_known=True`` (the tokens came from the doc's complete text)
    is authoritative — drop. Otherwise the text may be a truncated
    preview: drop only on FULL positive evidence (every positive term
    visible yet the structure still fails); absence of a term is
    unprovable and keeps the doc (the exact retrieval lane may already
    have proven it matches).
    """
    if matches(root, tokens):
        return False
    if full_known:
        return True
    token_set = set(tokens)
    return all(t in token_set for t in positive_terms)
