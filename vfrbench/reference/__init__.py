"""The plain references and the comparison that decides ``correct``.

Plain PyTorch in float32 with TF32 off, written from the model's
description (MCN, Hendricks et al. 2017; the preset's InfoNCE, Adam and
Polyak average), importing nothing of the port.  They recompute whatever
the port derives in its set-up (fused operands, squared norms, cast
weights) from the inputs the benchmark made, and read the port's outputs
only to judge them.
"""
