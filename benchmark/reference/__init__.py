"""The plain reference that decides ``correct``: float32 PyTorch (TF32 off),
written from the published descriptions. It imports nothing of the program
and takes nothing the program made: the frames come from the shards through
``frozen.eovc_raw``, the sampling and augmentation from ``frozen.threefry``
and numpy, the weights from the benchmark's own generator.
"""
