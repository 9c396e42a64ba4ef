"""``syncs_per_step``: the CUDA runtime calls that block the host
(``cudaDeviceSynchronize``, ``cudaStreamSynchronize``,
``cudaEventSynchronize``, ``cudaMemcpy``; a ``.item()`` or a copy to the
host shows as a stream synchronize) that lie inside one of the program's
``nbody3d.*`` spans, over the profiled stretch's steps.  The benchmark's
own waits lie outside every program span and are not counted.  None where
the program opens no span."""

BLOCKING = {"cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy"}


def read(rec):
    spans = [(s, e) for n, s, e in rec["host_events"] if n.startswith("nbody3d.")]
    if not spans or not rec["steps"]:
        return None
    calls = [(s, e) for n, s, e in rec["host_events"] if n in BLOCKING]
    inside = sum(any(lo <= s and e <= hi for lo, hi in spans) for s, e in calls)
    return inside / rec["steps"]
