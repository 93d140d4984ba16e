"""Drivers: how a traffic file's ``driver`` runs a cell (set-up, window, trace, comparison)."""
