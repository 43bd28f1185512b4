"""Plain PyTorch references, one module per discretisation, named by the
configuration files' "reference" key.  They import nothing of the
program."""
