"""What the work costs, computed from shapes: the model's FLOPs per image
(``flops``), the LPG kernels' bytes and operations (``lpg``), and the
published peaks of the card (``peaks``)."""
