"""Frozen copies of arithmetic the benchmark shares with the program.

Each module names the file of ``eov_tpu_torch`` and the commit (1d21111) it
was copied from. They are copies on purpose: a later change to the program
must not move the yardstick it is measured with. None imports the program.
"""
