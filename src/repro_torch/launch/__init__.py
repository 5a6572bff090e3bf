"""Launchers: serving steps and the serving launcher."""
