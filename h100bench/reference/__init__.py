"""Plain PyTorch references: no import of the measured program."""
