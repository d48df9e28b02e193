"""The repo's operator workflows and measurement tools (`tools/*.py`), on
the port: one module for each, with the same name, arguments, defaults
and printed lines.

    python -m tetraear_tpu_torch.tools.<name> [arguments]

make_fixture          golden or ETSI downlink IQ fixtures (host numpy)
continuous_capture    CaptureLoop on --device; every frame to JSONL, voice
listen_clear          clear texts to a log, voice calls to WAV clips
auto_capture          attempt loop until readable text or voice
decrypt_capture       common-key auto-decrypt, readable texts to a file
analyze_text          readable clear frames of a frames JSONL (host)
bruteforce_keys       TEA keys against a JSONL's encrypted frames (host)
list_bladerf_devices  the BladeRFs on this host (host)
verify_codec          the codec programs' I/O contracts (host)
codec_quality         the codec's round-trip quality (host)
sensitivity_sweep     downlink CRC-pass rate against SNR on --device
bench_scaling         weak scaling of the sharded step over ranks
comm_analysis         the sharded steps' collectives by kind, per mesh

A tool that touches tensors takes --device, cuda by default; without a
card it exits naming --device cpu.  Where the JAX tool's capture sources
take the BladeRF, the port's `ui.cli._make_source` opens it.  Each module
keeps its work under `main(argv)`: importing one runs nothing.
"""
