"""Level-set initialization and image I/O."""
