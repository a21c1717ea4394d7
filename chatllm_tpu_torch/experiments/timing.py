"""Host-clock timing shared by the design probes.

The JAX originals time one compiled program (a `scan` or `fori_loop` over
the kernel calls) with no host step inside it.  Here the same loop runs
eagerly, the host issuing every launch, and, on the card, also replayed
from one CUDA graph captured from it: the counterpart of the compiled loop,
with no host work between the kernels.
"""
from __future__ import annotations

import time

import torch


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_s(fn, device: torch.device) -> float:
    """Seconds of one call of `fn`, up to the end of its work on the device."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def capture(fn, device: torch.device) -> torch.cuda.CUDAGraph:
    """`fn` captured into one CUDA graph on the current stream's device.
    Every kernel wrapper `fn` reaches is called once during the capture (and
    counts its launches then); a replay goes through no wrapper.  `fn` must
    have run eagerly before, so that its kernel libraries are loaded."""
    if device.type != "cuda":
        raise RuntimeError("a CUDA graph needs a CUDA device")
    sync(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    sync(device)
    return graph


def best_replay_s(graph: torch.cuda.CUDAGraph, device: torch.device, runs: int = 3) -> float:
    """The fastest of `runs` timed replays, after one untimed one."""
    graph.replay()
    return min(run_s(graph.replay, device) for _ in range(runs))


def eager_and_graph_s(fn, device: torch.device) -> dict:
    """Seconds of one call of `fn`: "warm" (the first call, which builds and
    loads the kernels), "eager" (the second) and, on the card, "graph" (the
    best replay of one CUDA graph captured from `fn`).  Every wrapper `fn`
    reaches counts its launches three times: warm-up, eager and capture."""
    res = {"warm": run_s(fn, device), "eager": run_s(fn, device)}
    if device.type == "cuda":
        res["graph"] = best_replay_s(capture(fn, device), device)
    return res


def chain_s(step, reps: int, device: torch.device) -> float:
    """Seconds per call of `step` over a chain of `reps` calls (each call
    reads what the previous one wrote, so nothing hoists), after one
    warm-up call: on the card the best replay of one CUDA graph captured
    from the chain, on the CPU the best of 3 eager runs.  Every wrapper
    `step` reaches counts its launches 1 + reps times."""
    def run():
        for _ in range(reps):
            step()

    step()
    if device.type == "cuda":
        return best_replay_s(capture(run, device), device) / reps
    return min(run_s(run, device) for _ in range(3)) / reps
