"""One query a request: ``searcher.search(text, k)``, the library's own
call for a caller that waits for its answer."""


def bind(system, mix: dict):
    """(queries a request, function of a list of query texts -> outcomes)."""
    if mix["batch"] != 1:
        raise ValueError("a search() mix sends one query a request")
    searcher, k = system.searcher, mix["k"]
    return 1, lambda texts: [searcher.search(texts[0], k)]
