"""Entry points.  Counterpart of ``repro/launch``: the training loop
(``train``), the rank world it runs over under torchrun (``mesh``), and
elastic membership (``elastic``)."""
