"""``vjp_host_ms.grad`` (VJP): host milliseconds a rollout step inside the
program's ``nbody3d.vjp`` spans (the backward of each of its
``torch.autograd.Function``s, on autograd's device thread) in the
profiled stretch.  None where the program opens no such span."""


def read(rec):
    spans = [e - s for n, s, e in rec["host_events"] if n == "nbody3d.vjp"]
    if not spans or not rec["steps"]:
        return None
    return sum(spans) * 1e-3 / rec["steps"]
