"""host_decode.ms: the host decode's mean time per chunk, by the host
clock around each `MulticarrierDecoder.decode` call of the traced window
(its device-to-host pulls included)."""


def read(trace):
    spans = trace["host_decode_s"]
    return sum(spans) / len(spans) * 1e3 if spans else None
