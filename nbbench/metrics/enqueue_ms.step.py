"""``enqueue_ms.step`` (engine): host milliseconds a step inside
``Simulation.run_async`` (the Morton re-sort where it falls, and the
enqueue of the chunk's steps), the mean over the chunks of a ``--trace 1``
run outside its profiled stretch, on the benchmark's host clock."""


def read(rec):
    spans = rec["spans"].get("enqueue_s")
    if not spans:
        return None
    return sum(spans) / len(spans) / rec["spans"]["chunk_steps"] * 1e3
