"""Device math (JAX/XLA).

- ``gl``: batched Bayesian genotype-likelihood stage (the parity twin of
  ``svtyper_tpu.models.bayes``; reference ``classic.py::bayes_gt``).
"""

from svtyper_tpu.ops.gl import genotype_batch, log_choose_table  # noqa: F401
