"""The port's counterparts of the repository's `examples/` demos, as
modules: `python -m bds3_tpu_torch.examples.<name> [--device D]`.

`ldpc_decode_demo` runs on the host alone; `b2a_pipeline_demo` and
`b1c_pipeline_demo` render their captures and run the receiver on the
card unless `--device cpu` is given.  Each has `main(argv=None)`, which
returns the exit code, and a `run` that takes settings and a capture
already made."""
