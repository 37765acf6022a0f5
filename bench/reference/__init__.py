"""Plain PyTorch references of what the benchmark's cells train. They
import nothing of the port (``repro_torch``) and nothing of the JAX
package: they are the yardstick the port's timed path is held to."""
