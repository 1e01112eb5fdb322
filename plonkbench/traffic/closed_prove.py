"""Closed-loop proving traffic: one client sends its next request when the
last proof is back, as a proving service's worker pulls one job at a time.

A request is one witness from a pool built in set-up and 11 fresh blinding
scalars, all drawn from the seed, so every seed gives the same work (one
circuit, the same number of proofs of the same size) in another order of
other values. Parameters (the mix's file): ``clients`` (1), ``pool`` (the
distinct witnesses), ``check_sample`` (the proofs of the window that the
reference judges, at the least), ``split_sample`` (of those, the proofs on
which it also checks t's three pieces one by one; see
``reference/plonk.py``).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass

Q = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


@dataclass
class Request:
    index: int
    witness: int
    blinding: list


@dataclass
class Record:
    request: Request
    start: float
    end: float
    proof: bytes | None
    error: str | None


class Traffic:
    def __init__(self, mix: dict, seed: int, circuit, gates: int):
        if mix.get("clients", 1) != 1:
            raise ValueError("closed_prove drives one client")
        self.mix = mix
        self.seed = seed
        rng = random.Random(f"closed_prove/pool/{seed}")
        self.pool = [circuit.instance(gates, rng) for _ in range(mix["pool"])]
        self._rng = random.Random(f"closed_prove/requests/{seed}")
        self._count = 0

    def _blinding(self) -> list:
        return [self._rng.randrange(1, Q) for _ in range(11)]

    def warmup(self) -> Request:
        """The set-up's cold prove: a request outside the window."""
        return Request(-1, self._rng.randrange(len(self.pool)), self._blinding())

    def next_request(self) -> Request:
        req = Request(self._count, self._rng.randrange(len(self.pool)), self._blinding())
        self._count += 1
        return req

    def drive(self, serve, seconds: float) -> tuple[float, list[Record]]:
        """Requests back to back until ``seconds`` have passed since the
        first; the one under way then is the last. Returns (window start,
        records); a request's latency runs from its start to its proof's
        bytes on the host."""
        records = []
        clock = time.perf_counter
        t0 = clock()
        while not records or clock() - t0 < seconds:
            req = self.next_request()
            start = clock()
            try:
                proof, error = serve(req), None
            except Exception as e:  # a failed request is counted, and the window goes on
                proof, error = None, f"{type(e).__name__}: {e}"
            records.append(Record(req, start, clock(), proof, error))
        return t0, records

    def sample(self, records: list[Record]) -> list[tuple[Record, bool]]:
        """The finished requests that the reference judges, each with whether
        it checks t's split, in the window's order. Drawn from the seed, but
        always the window's first and last proofs and one of each pooled
        witness, then others up to ``check_sample``; the split on
        ``split_sample`` of them."""
        done = [r for r in records if r.proof is not None]
        rng = random.Random(f"closed_prove/sample/{self.seed}")
        chosen = {0, len(done) - 1} if done else set()
        for w in range(len(self.pool)):
            if not any(done[i].request.witness == w for i in chosen):
                of_w = [i for i, r in enumerate(done) if r.request.witness == w]
                if of_w:
                    chosen.add(rng.choice(of_w))
        rest = sorted(set(range(len(done))) - chosen)
        chosen |= set(rng.sample(rest, max(0, min(self.mix["check_sample"] - len(chosen), len(rest)))))
        chosen = sorted(chosen)
        split = set(rng.sample(chosen, min(self.mix.get("split_sample", 0), len(chosen))))
        return [(done[i], i in split) for i in chosen]
