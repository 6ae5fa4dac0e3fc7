"""Data generators, one file each: ``make(config, generator, device)``."""
