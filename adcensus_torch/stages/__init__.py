"""Pipeline stages of the one-pair AD-Census match."""
