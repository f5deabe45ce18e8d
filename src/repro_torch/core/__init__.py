"""Core of the port: the Symphony switch state machine and the simulator."""
