"""The port's twins of the repo's ``examples/`` scripts, each run as
``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu``) and callable as ``main(argv)``."""
