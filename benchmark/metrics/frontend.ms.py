"""frontend.ms: the frontend's mean device span per chunk, by CUDA events
recorded on the stream before and after each frontend call of the
traced window (the conv, the demod tail, the candidates and the gaps
between their launches)."""


def read(trace):
    spans = trace["frontend_ms"]
    return sum(spans) / len(spans) if spans else None
