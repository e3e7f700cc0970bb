from .recipe import (LSTMGridRandomRecipe, Recipe, SmokeRecipe,
                     TCNGridRandomRecipe)

__all__ = ["Recipe", "SmokeRecipe", "LSTMGridRandomRecipe",
           "TCNGridRandomRecipe"]
