"""Generator training on one GPU: the dataset, the train and eval steps,
the optimizer and the trainer's command line (``train.loop``)."""
