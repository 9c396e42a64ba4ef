"""``backward_ms.grad`` (VJP): host milliseconds a rollout step of
``torch.autograd.grad``, timed between a ``torch.cuda.synchronize()`` after
the forward and one after the backward, the mean over the gradients of a
``--trace 1`` run outside its profiled stretch."""


def read(rec):
    spans = rec["spans"].get("backward_s")
    if not spans:
        return None
    return sum(spans) / len(spans) / rec["spans"]["rollout"] * 1e3
