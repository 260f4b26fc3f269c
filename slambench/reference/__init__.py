"""The benchmark's yardstick: plain PyTorch and NumPy, frozen copies that
import nothing of the program under test."""
