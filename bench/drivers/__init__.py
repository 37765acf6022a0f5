"""The port's timed paths, one module per kind of job; a traffic file
names its driver."""
