"""barcoder_tpu — a JAX framework for CRISPR guide design and barcode
analytics on a GPU.

Built from scratch with the capabilities of the reference toolkit
(``ryandward/barcoder``): guide→genome mapping at 0–3 mismatches with PAM
filtering on circular bacterial genomes, genome-wide guide-library design,
high-throughput barcode counting in sequencing reads, mismatch-efficacy
modeling, and read preprocessing.

Where the reference shells out to the Bowtie 1 C++ aligner
(reference: targets.py:467-539, BowtieRunner.py:87-141), this framework packs
genomes into 2-bit device arrays and performs the alignment as a one-hot
matmul Hamming scan on the GPU's tensor cores (Pallas kernel, fused PAM
mask), sharding
the genome across a `jax.sharding.Mesh` with halo handling and merging
hits/counts via collectives.

Layers (bottom-up):
  - ``barcoder_tpu.seqio``    — GenBank / FASTA / FASTQ / SnapGene / TSV IO
  - ``barcoder_tpu.core``     — encoding, genome model, PAM, coordinates, locus join
  - ``barcoder_tpu.ops``      — device scan kernels (Pallas + pure-JAX reference + numpy oracle)
  - ``barcoder_tpu.parallel`` — mesh-sharded multi-device scan
  - ``barcoder_tpu.model``    — mismatch-efficacy linear model
  - ``barcoder_tpu.pipeline`` — end-to-end workloads (targets, design, count, distill)
  - ``barcoder_tpu.cli``      — command-line frontends
"""

__version__ = "0.1.0"
