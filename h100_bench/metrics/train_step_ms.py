"""train_step_ms: kernel time per training step: the kernels launched
inside the benchmark's ``bench_train_steps`` spans (each around one
block's steps, after its upload and before its evaluation), over the steps
in them."""

from h100_bench import trace as tr


def read(layer):
    evs = layer.get("events")
    n = layer.get("steps_spanned")
    if not evs or not n:
        return None
    sp = [(e["ts"], e["ts"] + e["dur"])
          for e in tr.spans(evs, "bench_train_steps")]
    t = sum(e["dur"] for e in tr.launched_inside(evs, sp))
    return t / n / 1e3 if t else None
