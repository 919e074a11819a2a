"""Plain PyTorch reference of the benchmark; imports nothing of the
program under test."""
