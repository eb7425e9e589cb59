"""Plain references that decide ``correct``.  They import nothing of the
program (``repro_torch``) and take nothing it made."""
