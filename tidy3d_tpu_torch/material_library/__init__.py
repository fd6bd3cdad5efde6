from .material_library import MaterialItem, VariantItem, material_library
