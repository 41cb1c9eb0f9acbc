"""Carrying weights between the JAX package's param trees and the port."""
