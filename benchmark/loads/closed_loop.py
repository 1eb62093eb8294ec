"""A closed loop: ``mix['clients']`` clients, each a thread that takes the
next request from the shared pool, sends it and waits for the answer
before it sends the next one. Requests start until the window closes; the
answers of those still running then are waited for.

A request keeps the answers of the pool's queries marked to be kept (a
share drawn from the seed, and the longest queries) and drops the rest at
once: answers held to the end would grow the interpreter's long-lived
objects, and with them the collector's full passes, inside the window.
"""

from __future__ import annotations

import itertools
import threading
import time

from benchmark.harness.window import Request


def run_window(call, size: int, mix: dict, pool: list[str], keep, seconds: float, span: str | None = None):
    """Drive the clients for ``seconds``; returns (requests, window start,
    window end, time the last answer came), on ``time.perf_counter``'s
    clock. ``call(texts)`` sends one request of ``size`` query texts and
    returns one outcome a query; ``keep[i]`` marks the pool's queries whose
    answers are kept. With ``span``, each request is a traced range of
    that name."""
    counter = itertools.count()
    clients = mix["clients"]
    barrier = threading.Barrier(clients)
    window: dict = {}
    per_client: list[list[Request]] = [[] for _ in range(clients)]
    if span is not None:
        from torch.profiler import record_function

    def client(c: int) -> None:
        barrier.wait()
        deadline = window["end"]
        out = per_client[c]
        while True:
            start = time.perf_counter()
            if start >= deadline:
                return
            first = next(counter) * size % len(pool)
            texts = pool[first : first + size]
            if len(texts) < size:
                texts = texts + pool[: size - len(texts)]
            req = Request(c, first, size, start)
            try:
                if span is not None:
                    with record_function(span):
                        outcomes = call(texts)
                else:
                    outcomes = call(texts)
                req.end = time.perf_counter()
                req.kept = [(texts[j], outcomes[j]) for j in range(size) if keep[(first + j) % len(pool)]]
            except Exception as exc:  # a failed request counts as failed, and the run goes on
                req.end = time.perf_counter()
                req.error = f"{type(exc).__name__}: {exc}"
            out.append(req)

    # client 0 runs on this thread, the others on threads of their own
    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}") for c in range(1, clients)]
    for t in threads:
        t.start()
    window["start"] = time.perf_counter()
    window["end"] = window["start"] + seconds
    client(0)
    for t in threads:
        t.join()
    last = time.perf_counter()
    requests = sorted(itertools.chain.from_iterable(per_client), key=lambda r: r.start)
    return requests, window["start"], window["end"], last
