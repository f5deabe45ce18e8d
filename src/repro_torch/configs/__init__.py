"""The assigned architectures as plain data (the port's copy of
``repro/configs``); ``registry`` maps ``--arch`` ids to them."""
