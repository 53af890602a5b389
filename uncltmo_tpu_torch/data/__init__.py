"""The training data of the port, produced on the host in numpy."""
