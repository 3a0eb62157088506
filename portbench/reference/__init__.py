"""Plain PyTorch references, one module a configuration family. They import
nothing of the measured program."""
