"""Faults the timed path of the wideband decode can have, planted where it
produces its answers, for showing that `correct` comes out false: the
program wrapped, put in its place through `harness.run`'s
`system_factory`.  The host-stage faults are planted on the carriers
with traffic (`busy`), where answers are due: a frame the host decodes
from a false sync on noise has no known answer to be held to."""

FAULTS = ("stale", "half_rows", "flip_bit", "drop_rows", "alter_text")


class Faulty:
    """The program with one fault of FAULTS planted."""

    def __init__(self, base, fault: str, busy):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.base, self.fault, self.last = base, fault, None
        self.busy = sorted(busy)

    def submit(self, x, start_index):
        res = self.base.submit(x, start_index)
        if self.fault == "stale":               # state returned unchanged
            prev, self.last = self.last, res
            return prev if prev is not None else res
        if self.fault == "half_rows":            # half the batch left out
            bits = res.bits.clone()
            bits[bits.shape[0] // 2:] = 0
            return res._replace(bits=bits)
        if self.fault == "flip_bit":             # an answer altered
            bits = res.bits.clone()
            bits[:, 700] ^= 1
            return res._replace(bits=bits)
        return res

    def complete(self, res):
        frames = self.base.complete(res)
        if self.fault == "drop_rows":            # half the rows not decoded
            skip = self.busy[0] % 2
            return [[] if i % 2 == skip else f for i, f in enumerate(frames)]
        if self.fault == "alter_text":           # a text altered
            for f in (f for row in self.busy for f in frames[row]):
                if "sds_message" in f:
                    f["sds_message"] = f["sds_message"][:-1] + "?"
                    break
        return frames
