"""The ``solve`` entry: one client, a closed loop of ``solve(op, b_k)``
against operators built once in set-up, one a matrix of the inputs
(``mix["warmup_solves"]`` solves before the window, on each matrix, on
right-hand sides no request uses).  Request ``k`` is the system
``inputs.request(k)``."""
import time

from harness.traffic import SETUP, sync

WARMUP = 2                       # the seed stream of warm-up right-hand sides


class Entry:
    def __init__(self, program, inputs, mix, device, loop):
        self.program, self.inputs, self.device, self.loop = (
            program, inputs, device, loop)
        self.ops = []
        for csr in inputs.matrices:
            t0 = time.perf_counter()
            self.ops.append(program.operator(csr))
            sync(device)
            loop.span("operator_build", t0, time.perf_counter(), SETUP)
        for m, op in enumerate(self.ops):
            for j in range(mix["warmup_solves"]):
                program.solve(op, inputs.rhs_for(m, j, device, WARMUP))
        sync(device)
        self.k = 0

    def run(self, until, phase):
        while True:
            m, b = self.inputs.request(self.k, self.device)
            t0 = time.perf_counter()
            res = self.program.solve(self.ops[m], b)
            sync(self.device)
            t1 = time.perf_counter()
            self.loop.span("solve", t0, t1, phase)
            self.loop.answer(self.k, res, t1 - t0, phase)
            self.k += 1
            if until(t1, 1):
                return

    def drain(self, grace_s):
        """Nothing is in flight between two calls."""

    def counters(self):
        return {}

    def close(self):
        self.ops = None
