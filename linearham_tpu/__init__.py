"""linearham_tpu: a JAX Bayesian phylo-HMM engine for BCR analysis.

A from-scratch JAX/XLA re-design of the capabilities of matsengrp/linearham
(reference layout documented in SURVEY.md).  The host side compiles a clonal
family's V(D)J state space into dense padded tensors once; the device side
runs Felsenstein pruning over the expanded MSA, the HMM forward pass, and
forward-filtering backward-sampling, batched over the whole posterior tree
ensemble and sharded over device meshes.

Layers:
  io/          ingestion of partis germline/cluster YAML, RevBayes trees TSV,
               Newick, FASTA (host, pure Python)
  compiler/    the "HMM compiler": state-space + transition-tensor + xMSA
               construction (host, numpy)
  ops/         JAX device kernels: forward, FFBS, GTR, Felsenstein pruning
  models/      SimpleHMM (star tree) and PhyloHMM user-facing APIs
  pipeline/    the batched posterior-ensemble pipeline + TSV output contract
  postprocess/ bootstrap/ESS/ASR, naive + lineage tabulation, annotations
  parallel/    device-mesh sharding utilities
"""

__version__ = "0.1.0"

from linearham_tpu.utils.constants import EPS  # noqa: F401
