"""Result records."""
