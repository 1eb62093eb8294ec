"""``mix['batch']`` queries a request: ``searcher.search_batch(texts, k)``,
the call a serve node makes when it flushes its coalesced queries."""


def bind(system, mix: dict):
    """(queries a request, function of a list of query texts -> outcomes)."""
    searcher, k = system.searcher, mix["k"]
    return mix["batch"], lambda texts: searcher.search_batch(texts, k)
