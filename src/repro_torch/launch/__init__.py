"""Launchers: the localhost socket cluster of party processes
(`launch.cluster`)."""
