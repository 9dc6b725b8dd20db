"""The plain reference of the benchmark (plain PyTorch, float32, TF32 off
where the caller sets it): the model (``model``), the input preparation
(``augment``), the training step (``train``) and the fp8 control
(``quant``).  Imports nothing of the program under test."""
