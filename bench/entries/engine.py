"""The ``engine`` entry: a closed loop that keeps ``mix["batch_slots"]``
requests in the program's engine, submitting request ``k`` (its matrix
and b, the matrix sent whole as a client sends it) for each one
harvested.

Set-up runs one request alone to its end (which warms every shape a tick
uses and counts the ticks of a solve), then fills the slots
``mix["stagger_fraction"]`` of a solve apart, so completions spread over
the window and do not come in waves, and ticks on to the next
completion, where the window opens: its first submit refills that slot,
so the window's rate counts whole periods of the loop."""
import time

from harness.traffic import DRAIN, SETUP


class Entry:
    def __init__(self, program, inputs, mix, device, loop):
        self.inputs, self.loop = inputs, loop
        self.eng = program.engine()
        self.sent = {}                  # request id -> (k, submit time)
        self.k = 0
        self._submit(SETUP)
        ticks, budget = 0, -(-program.cfg["maxiter"] // mix["chunk_iters"])
        while self.sent and ticks <= budget:
            self._tick(SETUP)
            ticks += 1
        stagger = max(1, round(ticks * mix["stagger_fraction"]))
        self.slots = mix["batch_slots"]
        for slot in range(self.slots):
            if slot:
                for _ in range(stagger):
                    self._tick(SETUP)
            if len(self.sent) < self.slots:
                self._submit(SETUP)
        self._refill(SETUP)
        for _ in range(budget):
            if self._tick(SETUP):
                break

    def _submit(self, phase):
        m, b = self.inputs.request(self.k, "cpu")
        t0 = time.perf_counter()
        rid = self.eng.submit(self.inputs.matrices[m], b)
        self.loop.span("admit", t0, time.perf_counter(), phase)
        self.sent[rid] = (self.k, t0)
        self.k += 1

    def _tick(self, phase):
        t0 = time.perf_counter()
        done = self.eng.step()
        t1 = time.perf_counter()
        self.loop.span("tick", t0, t1, phase)
        for rid, res in done.items():
            k, ts = self.sent.pop(rid)
            self.loop.answer(k, res, t1 - ts, phase)
        return len(done)

    def _refill(self, phase):
        while len(self.sent) < self.slots:
            self._submit(phase)

    def run(self, until, phase):
        """Refill the slots and tick until ``until(now, answered)`` holds
        after a tick; that tick's slots are not refilled."""
        while True:
            self._refill(phase)
            if until(time.perf_counter(), self._tick(phase)):
                return

    def drain(self, grace_s):
        """Tick without submitting until every request is answered or
        ``grace_s`` has passed; what is left never came."""
        t_end = time.perf_counter() + grace_s
        while self.sent and time.perf_counter() < t_end:
            self._tick(DRAIN)
        self.loop.missing = len(self.sent)

    def counters(self):
        return self.eng.counters()

    def close(self):
        self.eng = None
