"""Plain float64 reference of one BO suggestion round, independent of the port.

It imports nothing of the system under test and takes nothing the system made
except the answers it judges: the fitted hyperparameters, the jitter rung the
ladder accepted, and the suggested rows.
"""
