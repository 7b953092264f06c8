"""bds3_tpu_torch — the BDS-3 receiver on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of `bds3_tpu` (JAX/XLA/Pallas), which stays beside it as the
reference the port is tested against.  The modules mirror the reference's
layout: `acquire.{pcps,resample}`, `track.{state,scan,fused,prefix,
driver}`, `utils.phase`, `parallel` (on torch.distributed, one process
per rank), `receiver` and `__main__`, with the repository's example
and tool drivers as `examples` and `tools`.  The host modules
(`config`, `signals`, `navmsg`, `pvt`, `observe.{cn0,secondary,plots}`,
`io`) are the reference's, copied with the import prefix rewritten: the
port imports nothing of `bds3_tpu`.  `observe.plots` needs matplotlib,
and nothing else of the port imports it.

Ported: everything `bds3_tpu` does, for B2a and B1C in every track mode
(B1C's preset is wideband QMBOC with resampled acquisition), on real
int8 and float32 captures and complex IQ ones.  Every public entry point
takes an explicit `device`; on a CUDA device the tracking epochs run in
`csrc/track_fused.cu`, on the CPU in its plain PyTorch version
(`track.scan.track_block_reference`).

Importing this package, or any module of it, imports neither JAX nor
Triton and builds nothing: the CUDA library is compiled at first use
(`_build.py`).
"""
__version__ = "0.1.0"
