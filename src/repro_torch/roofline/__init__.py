"""Roofline accounting and profiler-trace readings for the port on an NVIDIA H100.

* :mod:`~repro_torch.roofline.analysis` -- the card's datasheet peaks and
  :class:`RooflineTerms` (port of ``repro.roofline.analysis``);
* :mod:`~repro_torch.roofline.analytic` -- exact FLOP accounting per
  (arch, shape), the decode kernels' traffic models, the predicted
  decode step, and each hand kernel's (bytes, operations) from its
  shapes (port of ``repro.roofline.analytic``);
* :mod:`~repro_torch.roofline.trace` -- the counterpart of
  ``repro.roofline.hlo_parse``: a ``torch.profiler`` run turned into
  plain records, and the device's idle share, its longest idle gaps with
  the host op that held them, kernel time by name, launches a step and
  their streams, and slab-sized cache copies read from those records.

None of them imports ``jax`` or the JAX package.
"""
