"""The port's counterparts of the repository's `tools/` drivers, as
modules: `python -m bds3_tpu_torch.tools.<name> [--device D]`
(`debug_pvt`, `validate_b1c_chain`, `streaming_demo`, `profile_trace`).

Each renders its capture on its device (`io.render`), runs on the card
unless `--device cpu` is given, and has `main(argv=None)`, which returns
the exit code, and a `run` that takes settings and a capture already
made.  Files they write go under `bds3_tpu_torch/_build/`."""
