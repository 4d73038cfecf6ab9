"""Training of the port: AdamW (``train.optim``), int8 gradient compression
(``train.grad_compress``) and the train step and loop (``train.loop``)."""
