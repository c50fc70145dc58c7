"""Launchers and step builders."""
