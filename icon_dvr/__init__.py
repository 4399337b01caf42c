"""icon_dvr — a direct-volume-rendering engine for ICON icosahedral
climate data, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the CUDA/OptiX
reference renderer (szellmann/icon-ray-tracing): Woodcock (delta) tracking of
scalar fields living on triangular prism columns of the ICON grid, with
progressive per-pixel accumulation, transfer-function classification,
empty-space-skipping acceleration structures, and multi-chip framebuffer
sharding over a `jax.sharding.Mesh`.

Layer map (bottom-up):
  utils/     — math + RNG + color primitives (ref: common/vecmath.h,
               common/dvr_course-common-both.h)
  data/      — .ic dataset IO + synthetic scenes (ref: tools/convert_icon)
  models/    — scene state pytrees: cells, transfer function, accel grids,
               cell locator (ref: icon_rt/ICONGrid.h, Params.h, hostCode.cu)
  ops/       — render math: camera, rays, DDA traversal, Woodcock tracking,
               full frame render (ref: icon_rt/deviceCode.cu, DDA.h,
               ShellAccel.h, UElems.h)
  parallel/  — multi-device sharding (new; the reference is single-GPU)
  pipeline/  — frame loop, CLI, .xf IO, TF editor (ref: common/pipeline.cu)
"""

__version__ = "0.1.0"
