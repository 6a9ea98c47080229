"""Eval-mode model zoo: MutanNoAtt backbone and NeuralCX."""
