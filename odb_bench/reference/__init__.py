"""The plain reference: float32 PyTorch (TF32 off) and NumPy, importing
nothing of the program.  ``<family>.py`` holds a model's loss over a
step's samples, ``train.py`` the optimizer and the readings compared,
``data.py`` the data path's expected output, ``quant.py`` the fp8 rounding
of the control."""
