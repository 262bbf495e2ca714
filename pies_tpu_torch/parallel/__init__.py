"""Multi-scene ensembles (port of ``pies_tpu/parallel``)."""
