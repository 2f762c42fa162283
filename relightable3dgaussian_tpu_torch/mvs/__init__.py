"""Offline multi-view-stereo data preparation, on the card.

Port of relightable3dgaussian_tpu/mvs/, the weight-free stand-in for the
reference's Vis-MVSNet pipeline (run_pre.sh:6-9), in four stages:

  1. `colmap_to_mvs`  COLMAP model → MVSNet `cams/*_cam.txt` + `pair.txt`
                      (numpy; colmap2mvsnet.py's semantics);
  2. `plane_sweep`    cascade ZNCC plane-sweep stereo in torch on the card:
                      3 stages at 1/4, 1/2, 1/1 resolution, streaming
                      soft-argmin, per-stage probability maps;
  3. `filter_fuse`    photometric (3-stage probability threshold) and
                      geometric (>= vthresh-view reprojection consistency)
                      filtering in torch (filter.py's rules);
  4. `prepare`        depth → normal and the `extra/{depths,normals,masks}`
                      files the Blender reader loads, or the NeILF inputs.
"""
from .colmap_to_mvs import colmap_to_mvs
from .filter_fuse import geometric_filter, prob_filter
from .formats import (load_cam_txt, load_pair_txt, write_cam_txt,
                      write_pair_txt)
from .plane_sweep import infer_depth
from .prepare import depth_to_normal, prepare_blender_extra

__all__ = [
    "colmap_to_mvs", "geometric_filter", "prob_filter",
    "load_cam_txt", "load_pair_txt", "write_cam_txt", "write_pair_txt",
    "infer_depth", "depth_to_normal", "prepare_blender_extra",
]
